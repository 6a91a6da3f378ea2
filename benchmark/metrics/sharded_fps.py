"""``sharded_fps``: the frames of every sharded encode call the window
completed on rank 0 (the call finishing across its end pro rata), over
the window's seconds (host clock).  Read in the traced run, whose
profiler covers some of the window's calls; a per-layer reading, since
the rate of a four-rank host's runs spreads too widely for a bound."""

from benchmark.metrics._common import frames_per_second


def read(run):
    return frames_per_second(run)
