"""``stats_wait_ms``: per GOP, the host's seconds blocked in the
program's ``device_encode+stats_fetch`` span while the card finishes the
GOP's DWT and bp R-D simulation, in ms."""

from benchmark.metrics._common import mean_span_ms


def read(run):
    return mean_span_ms(run, "device_encode+stats_fetch")
