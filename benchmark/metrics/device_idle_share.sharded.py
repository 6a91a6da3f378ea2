"""``device_idle_share.sharded``: on rank 0 of the sharded encode, the
share of the traced calls in which no kernel, copy or fill ran on its
card, in %."""

from benchmark.metrics._common import idle_percent


def read(run):
    return idle_percent(run)
