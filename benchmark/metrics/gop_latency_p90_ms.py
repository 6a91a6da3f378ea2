"""``gop_latency_p90_ms``: the 90th percentile, over every GOP finished
inside the window, of the time from the feed handing its frames to the
encode to its stream being finished (host clock)."""

from benchmark.metrics._common import quantile


def read(run):
    lat = [a.t_done - a.t_taken for a in run.finished()]
    q = quantile(lat, 0.9)
    return None if q is None else q * 1e3
