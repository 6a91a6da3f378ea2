"""Subband geometry over the packed DWT layout.

The texture codec decomposes each frame with ``Clevels = SRLs-1`` resolution
levels (mirroring the reference's Kakadu invocation,
``texture_compress_fb_j2k.py:193``).  The packed layout of
:mod:`qsvc_tpu.ops.dwt2d` stores all subbands in one array; this module maps
between that array and an explicit list of (level, band, array) — the unit
the EBCOT layer partitions into code-blocks.

Band naming follows J2K: HL = horizontally high-pass (top-right block in
the packed layout, because rows are transformed before columns), LH =
vertically high-pass (bottom-left), HH (bottom-right), plus the final LL.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass(frozen=True)
class BandInfo:
    """One subband of the packed pyramid."""
    level: int          # 1 = finest detail level .. L; LL has level L
    band: str           # "LL", "HL", "LH", "HH"
    y0: int
    x0: int
    h: int
    w: int

    @property
    def key(self) -> str:
        return f"{self.band}{self.level}"


def band_layout(H: int, W: int, levels: int) -> List[BandInfo]:
    """Subband regions in the packed array, finest level first, LL last."""
    bands: List[BandInfo] = []
    h, w = H, W
    for lv in range(1, levels + 1):
        lh, lw = h - h // 2, w - w // 2    # low sizes (ceil)
        hh, hw = h // 2, w // 2
        if hw:
            bands.append(BandInfo(lv, "HL", 0, lw, lh, hw))
        if hh:
            bands.append(BandInfo(lv, "LH", lh, 0, hh, lw))
        if hh and hw:
            bands.append(BandInfo(lv, "HH", lh, lw, hh, hw))
        h, w = lh, lw
    bands.append(BandInfo(levels, "LL", 0, 0, h, w))
    return bands


def extract(packed: np.ndarray, bands: List[BandInfo]) -> Dict[str, np.ndarray]:
    return {b.key: packed[..., b.y0:b.y0 + b.h, b.x0:b.x0 + b.w]
            for b in bands}


def assemble(sub: Dict[str, np.ndarray], bands: List[BandInfo],
             H: int, W: int, dtype=None) -> np.ndarray:
    first = next(iter(sub.values()))
    out = np.zeros(first.shape[:-2] + (H, W),
                   dtype or first.dtype)
    for b in bands:
        out[..., b.y0:b.y0 + b.h, b.x0:b.x0 + b.w] = sub[b.key]
    return out


def codeblock_tiles(h: int, w: int, cb: int) -> List[Tuple[int, int, int, int]]:
    """(y0, x0, h, w) tiles of a subband partitioned into code-blocks."""
    tiles = []
    for y0 in range(0, h, cb):
        for x0 in range(0, w, cb):
            tiles.append((y0, x0, min(cb, h - y0), min(cb, w - x0)))
    return tiles


# Synthesis-basis energy gain per band (L2 norm^2 of the synthesis basis
# vectors), used to weight distortion contributions so that coefficient-
# domain SSE approximates pixel-domain SSE.  For the reference-semantics
# integer 5/3 and the scaled 9/7 these are approximations; per-level gain
# doubles per dimension for the unnormalized 5/3.
def band_gain(band: str, level: int, reversible: bool) -> float:
    if reversible:
        return _rev_gain(band, level)
    # 9/7 with 1/K, K scaling is near-orthonormal
    return 1.0


def _rev_gain(band: str, level: int) -> float:
    """Approximate synthesis energy gain of the integer 5/3 pyramid: the
    low-pass synthesis doubles amplitude contribution per level and axis."""
    per_axis_low = 2.0
    if band == "LL":
        return (per_axis_low ** level) ** 2
    n_low_axes = {"HL": 1, "LH": 1, "HH": 0}[band]
    return (per_axis_low ** (level - 1)) ** 2 * (per_axis_low ** n_low_axes)
