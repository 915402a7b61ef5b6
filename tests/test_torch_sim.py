"""The port's swarm simulator (``kraken_tpu_torch.p2p.sim``) held against
``kraken_tpu.p2p.sim``: for every configuration of ``tests/test_sim.py``
but its 30k band (``slow`` there), ``run_sim`` of both packages gives
equal result dicts for the same seed.

The sim drives the production policy objects of its own package (request
manager, conn state, announce queue, tracker handout, fleet breakers), and
its determinism rides on the ``random`` module's state, seeded each run. So
an equal dict says that the port's policy modules draw from ``random`` in
the reference's order and decide as the reference does.
"""

import random

import pytest

from kraken_tpu.p2p import sim as jax_sim
from kraken_tpu_torch.p2p import sim as port_sim

CONFIGS = {
    "small_swarm": dict(n_agents=50, num_pieces=16, seed=7),
    "replay": dict(n_agents=120, num_pieces=16, seed=3),
    "flash_crowd": dict(n_agents=200, num_pieces=16, max_conns_per_torrent=10, seed=1),
    "origin_fast": dict(n_agents=100, num_pieces=16, seed=5),
    "origin_slow": dict(n_agents=100, num_pieces=16, seed=5, origin_uplink_bps=1.25e9 / 4),
    "cut_off": dict(n_agents=100, num_pieces=64, seed=2, max_sim_s=0.5),
    "downlink_free": dict(n_agents=100, num_pieces=16, seed=9),
    "downlink_capped": dict(n_agents=100, num_pieces=16, seed=9, downlink_bps=2.5e6),
    "image_layers": dict(n_agents=80, seed=4, blob_pieces=(16, 8, 4)),
    "image_single": dict(n_agents=80, seed=4, num_pieces=28),
    "restart_base": dict(n_agents=150, num_pieces=32, seed=6),
    "restart_wave": dict(n_agents=150, num_pieces=32, seed=6, restart_at_s=3.0,
                         restart_frac=0.33, restart_down_s=1.0, restart_lose_pieces=2),
    "fleet_single": dict(n_agents=200, num_pieces=16, seed=8),
    "fleet_three": dict(n_agents=200, num_pieces=16, seed=8, n_trackers=3),
    "fleet_1k_control": dict(n_agents=1000, num_pieces=64, seed=0, n_trackers=3),
    "fleet_1k_kill": dict(n_agents=1000, num_pieces=64, seed=0, n_trackers=3,
                          tracker_kill_at_s=3.0, tracker_kill=1),
    "blackhole_kill": dict(n_agents=200, num_pieces=16, seed=2, n_trackers=3,
                           tracker_kill_at_s=1.0, tracker_kill=1,
                           tracker_down_mode="blackhole", tracker_restart_after_s=5.0),
    "pex_1k_control": dict(n_agents=1000, num_pieces=64, seed=0, n_trackers=3, pex=True),
    "pex_1k_blackout": dict(n_agents=1000, num_pieces=64, seed=0, n_trackers=3, pex=True,
                            tracker_kill_at_s=3.0, tracker_kill_all=True),
    "stranded": dict(n_agents=200, num_pieces=32, seed=0, n_trackers=3, max_sim_s=120.0,
                     tracker_kill_at_s=1.0, tracker_kill_all=True),
    "rescued": dict(n_agents=200, num_pieces=32, seed=0, n_trackers=3, max_sim_s=120.0,
                    tracker_kill_at_s=1.0, tracker_kill_all=True, pex=True,
                    pex_interval_s=2.0),
    "pex_replay": dict(n_agents=150, num_pieces=16, seed=3, n_trackers=3, pex=True,
                       tracker_kill_at_s=1.0, tracker_kill_all=True),
    "regression_1k": dict(n_agents=1000, num_pieces=64, seed=0),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_sim_gives_the_references_result(name):
    kw = CONFIGS[name]
    state = random.getstate()
    try:
        ref = jax_sim.run_sim(**kw)
        port = port_sim.run_sim(**kw)
    finally:
        random.setstate(state)
    assert port == ref


def test_the_config_is_the_references():
    import dataclasses

    port = {f.name: f.default for f in dataclasses.fields(port_sim.SimConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_sim.SimConfig)}
    assert port == ref


def test_a_run_replays_and_a_seed_changes_it():
    kw = dict(n_agents=60, num_pieces=8, n_trackers=2, pex=True)
    a = port_sim.run_sim(seed=11, **kw)
    assert port_sim.run_sim(seed=11, **kw) == a
    assert port_sim.run_sim(seed=12, **kw) != a
    sim = port_sim.SwarmSim(port_sim.SimConfig(seed=11, **kw))
    assert sim.run() == a
