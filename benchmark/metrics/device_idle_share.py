"""``device_idle_share``: the share of the traced window in which no
kernel, copy or fill ran on the card, in %."""

from benchmark.metrics._common import idle_percent


def read(run):
    return idle_percent(run)
