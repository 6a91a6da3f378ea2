"""``gc_pause_ms``: per GOP, the host's seconds in Python's garbage
collector (the program's ``gc.collect`` spans), in ms."""

from benchmark.metrics._spans import host_ms


def read(run):
    return host_ms(run, "gc.collect")
