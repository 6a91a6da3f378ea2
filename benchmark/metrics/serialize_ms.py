"""``serialize_ms``: per GOP, the host's seconds in the program's
``stream.serialize`` span (``VideoStream.to_bytes``), in ms."""

from benchmark.metrics._spans import host_ms


def read(run):
    return host_ms(run, "stream.serialize")
