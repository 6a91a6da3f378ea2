"""``setup_s``: seconds from the launch of the run's process to the
window's start: ``import torch``, the program, the builds, the frames,
the prewarm and the warm-up (host clock)."""


def read(run):
    return run.setup_s
