"""The host's staging (the pinned buffer and the copy into it) and submit
(the host-to-device enqueue and the launch) of an ingest window, in ms a
window."""

from portbench import plane


def read(obs):
    return plane.per(plane.totals(), ("plane_s.ingest.stage", "plane_s.ingest.submit"),
                     "plane_n.ingest.stage", 1e3)
