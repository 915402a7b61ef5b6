"""Share (%) of the traced window in which no operation ran on the device."""

from portbench.readers import idle_pct


def read(obs):
    return idle_pct(obs)
