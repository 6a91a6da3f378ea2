"""The least time the card could take for each launch of the MCTF kernels
of one GOP, from the shapes of the cell's own level schedule.

The peaks and the counting rule are copies of ``chip_smoke.py``'s
``_bound``: every input byte read once and every output byte written
once at the published 3.35 TB/s of one H100 SXM's HBM3, or the
operations at the card's rate for them, whichever takes longer.

* ME refinement (``me_refine``): the three luma planes of the pyramid
  depth, the vectors in and out; 18 probes of |a - b| over each block's
  window, two fp32 lane operations a term.
* MC predict (``mc_predict``): both 4:4:4 reference stacks, the vectors,
  the prediction; four int32 operations an output.
* MC update, both directions (``mc_update<2>``): the 4:4:4 contributions,
  the vectors, the int32 sums of both directions; one int32 add an
  output.

The bound counts the work the encode needs, whatever kernel does it.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from .reference.config import CodecConfig

#: published HBM3 bandwidth of one H100 SXM, bytes per second
HBM_BYTES_PER_S = 3.35e12
#: int32 operations per second outside the tensor cores: 132 SMs x 64
#: INT32 lanes x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: fp32 lane operations per second: 132 SMs x 128 FP32 lanes x 1.98 GHz
FP32_OPS_PER_S = 132 * 128 * 1.98e9

#: the profiler's names of the kernels, by the part of the name it shows
KERNELS = {"me_refine": "me_refine_kernel",
           "mc_predict": "mc_predict_kernel",
           "mc_update2": "mc_update_kernel<2>"}


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """Seconds of a call: its bytes at the memory rate or its operations
    at ``ops_per_s``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def _ceil_half(x: int, times: int) -> int:
    for _ in range(times):
        x = (x + 1) // 2
    return x


def gop_launches(codec: dict) -> List[Tuple[str, float]]:
    """(kernel, bound seconds) of each launch of one GOP's MCTF analysis,
    in the order the card runs them: per temporal level, the refinement
    from the coarsest pyramid depth to the finest, then the prediction and
    the update.  Whole-pixel motion, no block overlap: the shapes of the
    flagship's path."""
    cfg = CodecConfig(**codec).replace(GOPs=1)
    H, W = cfg.pixels_in_y, cfg.pixels_in_x
    border = cfg.border_size
    out = []
    for lp in cfg.level_schedule():
        P, bs, sr = lp.pictures // 2, lp.block_size, lp.search_range
        By, Bx = H // bs, W // bs
        depths = max(int(round(math.log2(sr))) - 1, 0)
        win = bs + 2 * border
        for d in range(depths, -1, -1):
            ny, nx = _ceil_half(H, d), _ceil_half(W, d)
            by, bx = _ceil_half(By, d), _ceil_half(Bx, d)
            mv = P * 2 * 2 * by * bx * 4
            out.append(("me_refine", bound_s(
                3 * P * ny * nx * 2 + 2 * mv,
                P * by * bx * 18 * win * win * 2, FP32_OPS_PER_S)))
        mv = P * 2 * 2 * By * Bx * 4
        plane = P * 3 * H * W
        out.append(("mc_predict", bound_s(3 * plane * 2 + mv, 4 * plane,
                                          INT32_OPS_PER_S)))
        out.append(("mc_update2", bound_s(plane * 2 + mv + 2 * plane * 4,
                                          2 * plane, INT32_OPS_PER_S)))
    return out


def kernel_of(name: str):
    """The key of :data:`KERNELS` whose kernel ``name`` is, or None."""
    for key, part in KERNELS.items():
        if part in name:
            return key
    return None


def roofline_share(ops, codec: dict):
    """Σ bound / Σ device time over the MCTF launches among ``ops``
    ((name, start, end), in any order), each launch matched to its place
    in the GOP's sequence of :func:`gop_launches`; the launches before
    the first whole sequence's start and after the last one's end are left
    out.  None where the launches do not follow the sequence or no whole
    sequence was seen."""
    seq = gop_launches(codec)
    names = [k for k, _ in seq]
    runs = sorted(((a, b, kernel_of(n)) for n, a, b in ops
                   if kernel_of(n) is not None))
    if not runs:
        return None
    observed = [k for _, _, k in runs]
    L = len(seq)
    fits = [o for o in range(L)
            if all(observed[i] == names[(o + i) % L]
                   for i in range(len(observed)))]
    if len(fits) != 1:
        return None
    o = fits[0]
    first = (L - o) % L                  # index of the first whole GOP
    whole = (len(observed) - first) // L
    if whole < 1:
        return None
    bound = time = 0.0
    for i in range(first, first + whole * L):
        a, b, _ = runs[i]
        bound += seq[(o + i) % L][1]
        time += b - a
    return bound / time if time > 0 else None
