"""``native_entropy_ms``: per GOP, the program's ``native_entropy_coding``
span (the host's bp block coder), in ms."""

from benchmark.metrics._common import mean_span_ms


def read(run):
    return mean_span_ms(run, "native_entropy_coding")
