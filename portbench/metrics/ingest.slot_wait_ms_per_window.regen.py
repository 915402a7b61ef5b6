"""The origin's reader's wait for a free ingest window slot, in ms a window."""

from portbench import plane


def read(obs):
    return plane.per(plane.totals(), ("plane_s.ingest.slot",), "plane_n.ingest.slot", 1e3)
