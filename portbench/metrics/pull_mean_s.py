"""Mean time of every layer pull due in the window (s), from its due time
to its last byte; a pull that failed or never ended counts as the window
and the grace after it."""

import statistics

from portbench.readers import pull_latencies


def read(obs):
    lat = pull_latencies(obs)
    return statistics.fmean(lat) if lat else None
