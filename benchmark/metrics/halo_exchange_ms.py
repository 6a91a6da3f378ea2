"""``halo_exchange_ms``: per sharded call, the device time of nccl's
``SendRecv`` kernels (the halo exchanges) on rank 0 in the traced calls,
in ms."""

from benchmark.timeline import clip


def read(run):
    tr = run.trace
    if tr is None or tr.answers == 0:
        return None
    spans = [(a, b) for name, a, b in tr.ops if "SendRecv" in name]
    if not spans:
        return None
    return sum(b - a for a, b in clip(spans, tr.start, tr.end)) \
        / tr.answers * 1e3
