"""Piece bytes the agent received over the swarm, over the bytes its pulls needed."""

from portbench.readers import ratio


def read(obs):
    return ratio(obs, "settled", "bytes_down", "bytes_needed")
