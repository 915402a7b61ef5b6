"""Blob bytes whose metainfo was completed in the window, over its seconds
(GB/s). The window ends with the regeneration under way at ``--seconds``."""


def read(obs):
    return sum(r["bytes"] for r in obs["regens"]) / obs["window_s"] / 1e9
