"""The host's wait on the card in a verify flush, in ms: its bounds check
(a device sync) and its digest readback, over the run's flushes on the card."""

from portbench import plane


def read(obs):
    return plane.per(plane.totals(), ("plane_s.verify.check", "plane_s.verify.readback"),
                     "verify_flushes_cuda", 1e3)
