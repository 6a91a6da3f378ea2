"""``encode_fps``: the frames every GOP stream the window completed moves
the feed forward (the GOP finishing across its end pro rata), over the
window's seconds (host clock)."""

from benchmark.metrics._common import frames_per_second


def read(run):
    return frames_per_second(run)
