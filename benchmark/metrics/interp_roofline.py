"""``interp_roofline``: the MCTF's sub-pixel interpolation and decimation
regions' summed bound over their summed device time in the window, in %;
each ``mctf.interp`` span's bound from its region's bytes in the cell's
level schedule (:mod:`benchmark.interp_roofline`), not from the
program's own count."""

from benchmark.interp_roofline import roofline_share


def read(run):
    spans = [r for r in run.spans if r.get("device_stage") == "mctf.interp"
             and run.window_start <= r["ts"] <= run.window_end]
    share = roofline_share(spans, run.config["codec"])
    return None if share is None else 100.0 * share
