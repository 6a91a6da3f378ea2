"""Rate-distortion tooling: RD-curve tracing and slope calibration.

Port of ``qsvc_tpu/scal/rd.py``.  The reference ships two quality tools:

* ``psnr_vs_br.py`` — traces an RD curve by re-encoding at a sweep of
  quantization slopes and measuring kbps/PSNR per point;
* ``searchSlope_byDistortion_j2k.py`` — binary-searches the slope that
  hits a per-frame distortion target (searchSlope_byDistortion_j2k.py:1-80).

Here both operate on a single encoded :class:`VideoStream` **without
re-encoding**: every code-block pass carries its distortion-length slope,
so each probe is a truncation (a sort/slice) plus one decode, which runs
on ``device`` unless the caller passes its own ``expand_fn``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..codec.codestream import VideoStream
from ..io.yuv import Video, video_psnr
from . import extract, info


@dataclass
class RDPoint:
    quantization: float     # slope units (reference 42000-46000 range)
    kbps: float
    bytes: int
    psnr_y: float
    rmse_y: float


def _expand_on(device) -> Callable:
    from .. import api
    return functools.partial(api.expand, device=device)


def rd_curve(vs: VideoStream, original: Video,
             quantizations: Sequence[float],
             fps: float = 30.0,
             expand_fn: Optional[Callable] = None, *,
             device="cuda") -> List[RDPoint]:
    """Trace an RD curve from one encoded stream (``psnr_vs_br``).

    One truncation + decode per point; points are slope values in the
    reference's units (higher slope = lower rate).
    """
    if expand_fn is None:
        expand_fn = _expand_on(device)
    out: List[RDPoint] = []
    for q in quantizations:
        t = extract.quality_truncate(vs, quantization=q)
        si = info.stream_info(t, fps)
        rec = expand_fn(t)
        p = video_psnr(original, rec)[0]
        err = rec.y.astype(np.float64) - original.y.astype(np.float64)
        rmse = float(np.sqrt(np.mean(err * err)))
        out.append(RDPoint(q, si.kbps, si.total_bytes, p, rmse))
    return out


def rd_curve_gops(streams: Sequence[VideoStream], original: Video,
                  quantizations: Sequence[float],
                  fps: float = 30.0, *, device="cuda") -> List[RDPoint]:
    """RD curve over a per-GOP stream list (the streaming container):
    each probe truncates every GOP, decodes the sequence, and accounts
    the summed bytes."""
    from ..api import expand_gops
    out: List[RDPoint] = []
    for q in quantizations:
        ts = [extract.quality_truncate(s, quantization=q) for s in streams]
        nbytes = sum(len(s.to_bytes()) for s in ts)
        rec = expand_gops(ts, device=device)
        n = min(rec.frames, original.frames)
        rec, orig = rec[:n], original[:n]
        p = video_psnr(orig, rec)[0]
        err = rec.y.astype(np.float64) - orig.y.astype(np.float64)
        rmse = float(np.sqrt(np.mean(err * err)))
        seconds = n / fps
        out.append(RDPoint(q, nbytes * 8 / 1000.0 / seconds, nbytes, p,
                           rmse))
    return out


def search_slope_for_distortion(vs: VideoStream, original: Video,
                                target_rmse: float,
                                lo: float = 42000.0, hi: float = 50000.0,
                                tol: float = 16.0,
                                expand_fn: Optional[Callable] = None, *,
                                device="cuda") -> Tuple[float, RDPoint]:
    """Binary-search the quantization slope whose decoded RMSE is closest
    to (and not above) ``target_rmse`` (``searchSlope_byDistortion``).

    Higher slope truncates more -> higher RMSE, so RMSE is monotone
    non-decreasing in the slope; the search returns the largest slope (the
    smallest stream) whose RMSE stays <= target.
    """
    if expand_fn is None:
        expand_fn = _expand_on(device)

    def probe(q: float) -> RDPoint:
        return rd_curve(vs, original, [q], expand_fn=expand_fn,
                        device=device)[0]

    best = probe(lo)
    if best.rmse_y > target_rmse:
        return lo, best            # even the finest point misses the target
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        pt = probe(mid)
        if pt.rmse_y <= target_rmse:
            lo, best = mid, pt
        else:
            hi = mid
    return lo, best


def format_curve(points: Sequence[RDPoint]) -> str:
    """gnuplot-ready table (the ``.dat`` files of the reference's RD
    experiments, tests/RD-*.sh)."""
    lines = ["# quantization  kbps  bytes  PSNR_Y(dB)  RMSE_Y"]
    for p in points:
        lines.append(f"{p.quantization:10.1f} {p.kbps:10.2f} {p.bytes:10d} "
                     f"{p.psnr_y:8.3f} {p.rmse_y:8.4f}")
    return "\n".join(lines)
