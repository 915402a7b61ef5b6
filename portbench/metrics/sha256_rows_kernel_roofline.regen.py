"""Share (%) of sha256_rows_kernel's device time that the window's SHA-256 work needs at the card's peaks."""

from portbench.readers import roofline_pct


def read(obs):
    return roofline_pct(obs)
