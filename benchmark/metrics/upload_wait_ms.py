"""``upload_wait_ms``: per GOP, the host's seconds in the program's
``upload`` span (the pageable copy of the GOP's frames to the card,
which first waits for the work queued before it), in ms."""

from benchmark.metrics._spans import host_ms


def read(run):
    return host_ms(run, "upload")
