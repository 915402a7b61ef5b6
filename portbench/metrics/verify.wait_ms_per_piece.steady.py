"""A verified piece's wait in the batched verify's queue and then for its
hash thread, in ms, over the pieces through the verify in the run."""

from portbench import plane


def read(obs):
    return plane.per(plane.totals(), ("plane_s.verify.queue", "plane_s.verify.pool"),
                     "verify_pieces", 1e3)
