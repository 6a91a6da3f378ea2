"""``parse_fragments_ms``: per sharded call, rank 0's ``parse_fragments``
span (every rank's fragment stream parsed back), in ms."""

from benchmark.metrics._common import mean_span_ms


def read(run):
    return mean_span_ms(run, "parse_fragments")
