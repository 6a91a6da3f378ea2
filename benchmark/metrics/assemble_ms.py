"""``assemble_ms``: per GOP, the host's seconds in the program's
``motion_coding`` and ``assemble_stream`` spans (the motion fields'
entropy coding, the per-level truncation and the building of the
stream's sections), in ms."""

from benchmark.metrics._spans import host_ms


def read(run):
    return host_ms(run, "motion_coding", "assemble_stream")
