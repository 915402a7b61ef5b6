"""Pieces through the agent's batched verify, over its SHA-256 launches (sha256_ragged)."""

from portbench.readers import ratio


def read(obs):
    return ratio(obs, "window", "verify_pieces", "launches.sha256_ragged")
