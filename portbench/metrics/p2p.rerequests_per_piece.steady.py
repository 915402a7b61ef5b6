"""Pieces the dispatcher requested again (expired, rescue, endgame), over
the pieces through the verify in the run."""

from portbench import plane


def read(obs):
    return plane.per(plane.totals(), ("rerequests",), "verify_pieces")
