"""Pieces the origin's pipeline hashed on the card, over its sha256_uniform launches."""

from portbench.readers import ratio


def read(obs):
    return ratio(obs, "window", "rows_hashed", "launches.sha256_uniform")
