"""``dispatch_host_ms``: per GOP, the host's seconds in the program's
``upload+mctf_dispatch`` and ``texture_dispatch`` spans (the API layer
queueing a GOP's device work), in ms."""

from benchmark.metrics._common import mean_span_ms


def read(run):
    return mean_span_ms(run, "upload+mctf_dispatch", "texture_dispatch")
