"""``mctf_device_ms``: per GOP, the card's time in the captured MCTF
analysis (``graph.analyze`` device spans: motion estimation, prediction
and update over every temporal level), in ms."""

from benchmark.metrics._spans import device_ms


def read(run):
    return device_ms(run, "graph.analyze")
