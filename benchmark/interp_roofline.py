"""The least time the card could take for each sub-pixel interpolation
and decimation region of one GOP's MCTF analysis (the program's
``mctf.interp`` spans), from the shapes of the cell's own level schedule
and ``subpixel_accuracy``.

A region's bound is its bytes at the published 3.35 TB/s of one H100
SXM's HBM3 (:data:`benchmark.roofline.HBM_BYTES_PER_S`): the least
traffic the encode needs there, whatever kernel does it, at the int16
the MCTF holds between steps.  Each region reads its first input once
and writes once each output that leaves it; the x2 steps between need
not leave the chip.  Per temporal level t of P pairs (P + 1 evens, P
odds) of H x W lumas, at accuracy a:

* ``me_up``, step s = 1 ... a: the motion search's evens and odds, 2P + 1
  lumas, from (H, W) << (s - 1) to (H, W) << s.  The refinement at each
  step reads that step's output, so each step writes it; step 1 reads
  the frames, and a later step's input is step s - 1's output, which one
  kernel may write beside its own (not counted again);
* ``pred_up``: the prediction's 4:4:4 evens, 3 (P + 1) planes, read at
  (H, W) and written at (H, W) << a;
* ``pred_down``: the 4:4:4 predictions, 3P planes, read at (H, W) << a
  and written at (H, W).

The count is the work the encode needs, whatever kernel does it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .reference.config import CodecConfig
from .roofline import HBM_BYTES_PER_S

#: bytes of a sample between steps (the MCTF's int16)
SAMPLE_BYTES = 2


def _traffic(planes: int, pixels: int, steps: int, up: bool,
             reads: bool = True) -> Tuple[int, int]:
    """(samples written by every step, least bytes) of ``steps`` x2
    steps over ``planes`` planes of ``pixels`` samples each: the input
    read once where ``reads``, the last output written once."""
    n = planes * pixels
    samples, nbytes = 0, n * SAMPLE_BYTES if reads else 0
    for _ in range(steps):
        n = 4 * n if up else n // 4
        samples += n
    return samples, nbytes + n * SAMPLE_BYTES


def gop_regions(codec: dict) -> List[Dict[str, int]]:
    """Each region of one GOP's analysis in the order the card runs them,
    as ``{"level", "part", "step", "samples", "bytes"}`` (``step`` None
    but for ``me_up``); none at whole-pixel accuracy."""
    cfg = CodecConfig(**codec).replace(GOPs=1)
    a = cfg.subpixel_accuracy
    HW = cfg.pixels_in_y * cfg.pixels_in_x
    out = []
    if a == 0:
        return out
    for lp in cfg.level_schedule():
        t, P = lp.temporal_subband, lp.pictures // 2

        def region(part, planes, pixels, steps, up, step=None, reads=True):
            samples, nbytes = _traffic(planes, pixels, steps, up, reads)
            out.append({"level": t, "part": part, "step": step,
                        "samples": samples, "bytes": nbytes})
        for s in range(1, a + 1):
            region("me_up", 2 * P + 1, HW << 2 * (s - 1), 1, True, s,
                   reads=s == 1)
        region("pred_up", 3 * (P + 1), HW, a, True)
        region("pred_down", 3 * P, HW << 2 * a, a, False)
    return out


def gop_bytes(codec: dict) -> int:
    """The bytes of one GOP's regions, summed."""
    return sum(r["bytes"] for r in gop_regions(codec))


def _key(r: dict) -> tuple:
    return (r.get("level"), r.get("part"), r.get("step"))


def roofline_share(spans: Sequence[dict], codec: dict) -> Optional[float]:
    """Σ bound / Σ device time over ``spans`` (``mctf.interp`` device span
    records), each span's bound the bytes of its (level, part, step) in
    :func:`gop_regions` at :data:`HBM_BYTES_PER_S`; None without spans or
    time, or where a span names no region of the schedule."""
    bounds = {_key(r): r["bytes"] / HBM_BYTES_PER_S
              for r in gop_regions(codec)}
    if not spans or any(_key(s) not in bounds for s in spans):
        return None
    time = sum(s["device_seconds"] for s in spans)
    if time <= 0:
        return None
    return sum(bounds[_key(s)] for s in spans) / time
