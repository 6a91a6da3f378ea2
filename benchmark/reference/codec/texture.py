"""The texture encode of a stack of planes: DWT, quantization, code-block
tiling, the bp R-D simulation, the block selection, the bp block coder and
the hull slopes.

A frozen copy of the encode half of ``qsvc_tpu_torch/codec/frame_codec.py``
(``_dwt_quant``, ``_dwt_quant_tiles``, ``_slope_floor``, ``_hull_slopes``,
``_tile_template``, the records and the selection of
``encode_frames_*_sparse``), with the block coder of :mod:`.bp` in place
of the native one.  Each tensor step is the same operation on the same
shapes as the program's, so on one device the two give the same numbers.
``dtype`` is the float type of the 9/7 transform and its quantization:
float32 as the configuration states; a lower one makes the control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import dwt2d
from . import bp, bp_device, subbands

#: threshold T(u) = 2**((u - SLOPE_ANCHOR)/256) (the stream's slope units)
SLOPE_ANCHOR = 43500.0


def slope_to_threshold(u: float) -> float:
    return float(2.0 ** ((float(u) - SLOPE_ANCHOR) / 256.0))


def threshold_to_slope(t: float) -> float:
    if t <= 0:
        return 0.0
    return SLOPE_ANCHOR + 256.0 * math.log2(t)


@dataclass
class Block:
    band_key: str
    level: int
    band: str
    y0: int
    x0: int
    shape: Tuple[int, int]
    msbs: int
    data: bytes
    pass_ends: List[int]
    pass_slopes: List[float]

    def truncate(self, threshold: float) -> "Block":
        """Only the passes whose hull slope reaches ``threshold``."""
        n = 0
        for s in self.pass_slopes:
            if s >= threshold:
                n += 1
            else:
                break
        if n == len(self.pass_ends):
            return self
        end = self.pass_ends[n - 1] if n else 0
        return Block(self.band_key, self.level, self.band, self.y0, self.x0,
                     self.shape, self.msbs, self.data[:end],
                     self.pass_ends[:n], self.pass_slopes[:n])


@dataclass
class Frame:
    H: int
    W: int
    levels: int
    reversible: bool
    delta: float
    codeblock_size: int
    blocks: List[Block]
    coder: str = "bp"

    def truncate(self, threshold: float) -> "Frame":
        return Frame(self.H, self.W, self.levels, self.reversible,
                     self.delta, self.codeblock_size,
                     [b.truncate(threshold) for b in self.blocks], self.coder)


def dwt_quant(plane: torch.Tensor, levels: int, reversible: bool,
              delta: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Forward texture DWT + quantization, int32 (batches over N)."""
    if reversible:
        return dwt2d.analyze(plane.to(torch.int32) - 128, levels, "5/3")
    c = dwt2d.analyze(plane.to(dtype) - 128.0, levels, "9/7")
    return torch.trunc(c / delta.to(dtype)).to(torch.int32)


def hull_slopes(pass_ends: Sequence[int], dists: Sequence[float],
                dist0: float, weight: float) -> List[float]:
    """Convex-hull distortion-length slopes; passes off the hull take the
    slope of the hull segment over them; non-increasing."""
    n = len(pass_ends)
    if n == 0:
        return []
    rates = [0] + list(pass_ends)
    dd = [dist0] + list(dists)
    hull = [0]
    for i in range(1, n + 1):
        if dd[i] >= dd[hull[-1]]:
            continue
        while hull:
            j = hull[-1]
            if rates[i] <= rates[j]:
                if j == 0:
                    break
                hull.pop()
                continue
            s_new = (dd[j] - dd[i]) / (rates[i] - rates[j])
            if len(hull) >= 2:
                k = hull[-2]
                s_old = (dd[k] - dd[j]) / max(rates[j] - rates[k], 1e-12)
                if s_new >= s_old:
                    hull.pop()
                    continue
            break
        hull.append(i)
    slopes = [0.0] * n
    prev = hull[0]
    for idx in hull[1:]:
        s = (dd[prev] - dd[idx]) / max(rates[idx] - rates[prev], 1e-12)
        for p in range(prev, idx):
            slopes[p] = s * weight
        prev = idx
    for p in range(prev, n):
        slopes[p] = 0.0
    for p in range(1, n):
        if slopes[p] > slopes[p - 1]:
            slopes[p] = slopes[p - 1]
    return slopes


def tile_template(H: int, W: int, levels: int, cb: int) -> List[Tuple]:
    """(band, ty, tx, th, tw, gain_rev, gain_irr) per code-block of one
    frame, in layout order."""
    tpl = []
    for b in subbands.band_layout(H, W, levels):
        g_rev = subbands.band_gain(b.band, b.level, True)
        g_irr = subbands.band_gain(b.band, b.level, False)
        for (ty, tx, th, tw) in subbands.codeblock_tiles(b.h, b.w, cb):
            tpl.append((b, ty, tx, th, tw, g_rev, g_irr))
    return tpl


def _tiles(q: torch.Tensor, levels: int, cb: int) -> torch.Tensor:
    """(N, nb, cb, cb) int16 code-blocks in template order, edge tiles
    zero-padded; raises if a coefficient does not fit int16."""
    q16 = q.to(torch.int16)
    if bool((q16.to(torch.int32) != q).any()):
        raise ValueError("a coefficient does not fit int16: the reference "
                         "codes int16 code-blocks only")
    N, H, W = q16.shape
    parts = []
    for b in subbands.band_layout(H, W, levels):
        band = q16[:, b.y0:b.y0 + b.h, b.x0:b.x0 + b.w]
        nh, nw = -(-b.h // cb), -(-b.w // cb)
        band = F.pad(band, (0, nw * cb - b.w, 0, nh * cb - b.h))
        parts.append(band.reshape(N, nh, cb, nw, cb)
                     .permute(0, 1, 3, 2, 4).reshape(N, nh * nw, cb, cb))
    return torch.cat(parts, dim=1)


def _weights(tpl, reversible: bool, delta: float) -> np.ndarray:
    return np.asarray([g_rev if reversible else g_irr * delta * delta
                       for (_b, _ty, _tx, _th, _tw, g_rev, g_irr) in tpl],
                      np.float64)


def encode_planes(planes: torch.Tensor, levels: int, reversible: bool,
                  delta: float, cb: int, min_threshold: np.ndarray,
                  dtype=torch.float32
                  ) -> Tuple[List[Frame], torch.Tensor, np.ndarray]:
    """Encode a (N, H, W) stack; ``min_threshold`` per plane.  The blocks
    kept are those with a coefficient whose first hull segment reaches
    the plane's threshold (bp coder); each is coded with an early stop at
    an eighth of it.  Returns the frames, the quantized code-blocks they
    code, (N, nb, cb, cb), and each code-block's distortion weight."""
    dev = planes.device
    N, H, W = planes.shape
    tpl = tile_template(H, W, levels, cb)
    nb = len(tpl)
    d = torch.tensor(delta, dtype=torch.float32, device=dev)
    tiles = _tiles(dwt_quant(planes, levels, reversible, d, dtype), levels,
                   cb)
    maxabs = tiles.to(torch.int32).abs().amax(dim=(2, 3))
    th_np = np.asarray([t[3] for t in tpl], np.int32)
    tw_np = np.asarray([t[4] for t in tpl], np.int32)
    th = torch.from_numpy(np.tile(th_np, N)).to(dev)
    tw = torch.from_numpy(np.tile(tw_np, N)).to(dev)
    smax, _d0 = bp_device.bp_max_slope(tiles.reshape(N * nb, cb, cb), th,
                                       tw)
    thr = np.broadcast_to(np.asarray(min_threshold, np.float64), (N,))
    wts = _weights(tpl, reversible, float(delta))
    if np.any(thr > 0):
        floor = (thr[:, None] / wts[None, :]).astype(np.float32)
    else:
        floor = np.zeros((N, nb), np.float32)
    keep = (maxabs > 0) & (smax.reshape(N, nb)
                           >= torch.as_tensor(floor, device=dev))
    flat_idx = np.flatnonzero(keep.cpu().numpy().ravel())
    kept = tiles.reshape(N * nb, cb, cb)[
        torch.as_tensor(flat_idx, device=dev, dtype=torch.int64)]
    metas, min_slopes = [], []
    for fi in flat_idx:
        n, ti = divmod(int(fi), nb)
        metas.append((n, ti))
        w = wts[ti]
        min_slopes.append(thr[n] / w / 8.0 if thr[n] > 0 else 0.0)
    codes = bp.encode_blocks(kept, [tpl[ti][3] for _, ti in metas],
                             [tpl[ti][4] for _, ti in metas], min_slopes)
    coded: Dict[Tuple[int, int], Block] = {}
    for (n, ti), c in zip(metas, codes):
        (b, ty, tx, bh, bw, _gr, _gi) = tpl[ti]
        coded[(n, ti)] = Block(b.key, b.level, b.band, ty, tx, (bh, bw),
                               c.msbs, c.data, c.pass_ends,
                               hull_slopes(c.pass_ends, c.pass_dist,
                                           c.dist0, float(wts[ti])))
    frames = []
    for n in range(N):
        blocks = []
        for ti, (b, ty, tx, bh, bw, _gr, _gi) in enumerate(tpl):
            blocks.append(coded.get((n, ti)) or Block(
                b.key, b.level, b.band, ty, tx, (bh, bw), 0, b"", [], []))
        frames.append(Frame(H, W, levels, reversible, float(delta), cb,
                            blocks))
    return frames, tiles, wts
