"""Median of the layer pulls due in the window (s), on the load generator's clock."""

from portbench.readers import pull_quantile


def read(obs):
    return pull_quantile(obs, 0.5)
