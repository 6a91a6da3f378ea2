"""``mctf_kernels_roofline``: the MCTF kernels' (ME refinement, MC
predict, MC update) summed bound over their summed device time in the
traced window, in %; each launch's bound from its shapes in the cell's
level schedule (:mod:`benchmark.roofline`)."""

from benchmark.roofline import roofline_share


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ops = [(n, a, b) for n, a, b in tr.ops if a >= tr.start and b <= tr.end]
    share = roofline_share(ops, run.config["codec"])
    return None if share is None else 100.0 * share
