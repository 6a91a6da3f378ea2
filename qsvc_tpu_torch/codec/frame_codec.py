"""Per-frame texture codec: DWT + quantization + EBCOT over code-blocks.

Port of ``qsvc_tpu/codec/frame_codec.py``.  The device half runs on
torch tensors on the caller's device: DC level shift, ``SRLs-1``-level
2D DWT (reversible 5/3 or irreversible 9/7), deadzone quantization and
code-block tiling, the bp R-D simulation (:mod:`.bp_device`) and the
block selection on encode; tile scatter, dequantization and inverse DWT
on decode.  Tier-1 entropy coding runs on the host in the native coder
(:mod:`.fast`).  The host-only parts (block/frame records, slope units,
hull slopes, tile templates) are copies of the JAX package's.

The device stages the JAX package jits run as captured programs
(``utils/graphs.py``): on encode, DWT + quantize + tile, the bp R-D
simulation and the block compaction as one program per (N, H, W, levels,
reversible, cb) (:func:`_encode_device`); on decode, the dequantization
and inverse DWT (:func:`_dequant_idwt`).  The tile scatter stays eager:
its tile count changes with every call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import dwt2d
from ..utils import graphs, trace
from . import bp_device, fast, subbands

#: slope-unit mapping: threshold T(u) = 2**((u - SLOPE_ANCHOR)/256), chosen
#: so the reference's useful 42000-46000 slope range spans the useful
#: distortion-per-byte range of 8-bit video (42000 ~ near-transparent,
#: 45000 ~ mid-rate, 46000 ~ very low rate; calibrated on 1080p content).
SLOPE_ANCHOR = 43500.0


def slope_to_threshold(u: float) -> float:
    return float(2.0 ** ((float(u) - SLOPE_ANCHOR) / 256.0))


def threshold_to_slope(t: float) -> float:
    if t <= 0:
        return 0.0
    return SLOPE_ANCHOR + 256.0 * math.log2(t)


@dataclass
class EncodedBlock:
    band_key: str
    level: int
    band: str
    y0: int
    x0: int
    shape: Tuple[int, int]
    msbs: int
    data: bytes
    pass_ends: List[int]
    pass_slopes: List[float]        # hull slope (weighted SSE per byte)

    @property
    def num_passes(self) -> int:
        return len(self.pass_ends)

    def truncate(self, threshold: float) -> "EncodedBlock":
        """Keep only passes whose hull slope >= threshold (no re-encode)."""
        n = 0
        for s in self.pass_slopes:
            if s >= threshold:
                n += 1
            else:
                break
        if n == len(self.pass_ends):
            return self                 # nothing cut (incl. empty blocks)
        end = self.pass_ends[n - 1] if n else 0
        return EncodedBlock(self.band_key, self.level, self.band, self.y0,
                            self.x0, self.shape, self.msbs, self.data[:end],
                            self.pass_ends[:n], self.pass_slopes[:n])

    def passes_for_threshold(self, threshold: float) -> int:
        n = 0
        for s in self.pass_slopes:
            if s >= threshold:
                n += 1
            else:
                break
        return n


@dataclass
class EncodedFrame:
    H: int
    W: int
    levels: int
    reversible: bool
    delta: float                     # base quantization step (9/7 path)
    codeblock_size: int
    blocks: List[EncodedBlock]
    coder: str = "mq"                # "mq" (spec MQ) | "bp" (bit-parallel)

    @property
    def total_bytes(self) -> int:
        return sum(len(b.data) for b in self.blocks)

    def truncate(self, threshold: float) -> "EncodedFrame":
        return EncodedFrame(self.H, self.W, self.levels, self.reversible,
                            self.delta, self.codeblock_size,
                            [b.truncate(threshold) for b in self.blocks],
                            self.coder)

def _dwt_quant(plane: torch.Tensor, levels: int, reversible: bool,
               delta: torch.Tensor) -> torch.Tensor:
    """Forward texture DWT + quantization, int32 (batches over N)."""
    if reversible:
        return dwt2d.analyze(plane.to(torch.int32) - 128, levels, "5/3")
    c = dwt2d.analyze(plane.to(torch.float32) - 128.0, levels, "9/7")
    return torch.trunc(c / delta).to(torch.int32)


def _dequant_idwt(q: torch.Tensor, levels: int, reversible: bool,
                  delta: torch.Tensor) -> torch.Tensor:
    """Dequantization + inverse DWT; (N, H, W) int32 pixels in [0, 255]."""
    if reversible:
        rec = dwt2d.synthesize(q.to(torch.int32), levels, "5/3") + 128
        return rec.clamp(0, 255).to(torch.int32)
    v = q.to(torch.float32)
    v = (v + torch.where(v > 0, 0.5, torch.where(v < 0, -0.5, 0.0))) * delta
    rec = dwt2d.synthesize(v, levels, "9/7") + 128.0
    return torch.round(rec).clamp(0, 255).to(torch.int32)


#: :func:`_dequant_idwt` as a captured program, per (N, H, W, levels,
#: reversible)
_dequant_idwt_jit = graphs.captured(_dequant_idwt)


def _hull_slopes(pass_ends: Sequence[int], dists: Sequence[float],
                 dist0: float, weight: float) -> List[float]:
    """Convex-hull distortion-length slopes; non-hull passes inherit the
    slope of the hull segment that covers them (so threshold truncation is
    monotone and never cuts inside a hull segment)."""
    n = len(pass_ends)
    if n == 0:
        return []
    rates = [0] + list(pass_ends)
    dd = [dist0] + list(dists)
    # convex hull (lower envelope) over (rate, dist).  A pass that does not
    # strictly reduce distortion below the current hull top is dominated
    # (>= rate, >= dist) and is skipped — it must NOT pop the top, or a
    # flat pass after a steep one would discard the best truncation point.
    hull = [0]
    for i in range(1, n + 1):
        if dd[i] >= dd[hull[-1]]:
            continue
        while hull:
            j = hull[-1]
            if rates[i] <= rates[j]:
                if j == 0:          # keep the zero-rate origin vertex
                    break
                hull.pop()          # same or less rate, strictly less dist
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
    # slope per pass = hull-segment slope covering that pass
    slopes = [0.0] * n
    prev = hull[0]
    for idx in hull[1:]:
        s = (dd[prev] - dd[idx]) / max(rates[idx] - rates[prev], 1e-12)
        for p in range(prev, idx):
            slopes[p] = s * weight
        prev = idx
    for p in range(prev, n):
        slopes[p] = 0.0
    # enforce monotone non-increasing slopes (numerical safety)
    for p in range(1, n):
        if slopes[p] > slopes[p - 1]:
            slopes[p] = slopes[p - 1]
    return slopes


#: per-(H, W, levels, codeblock) tile template: (band, ty, tx, th, tw,
#: gain_rev, gain_irr) for one frame in layout order.
_TEMPLATE_CACHE: Dict[Tuple[int, int, int, int], List[Tuple]] = {}


def _tile_template(H: int, W: int, levels: int, cb: int) -> List[Tuple]:
    key = (H, W, levels, cb)
    tpl = _TEMPLATE_CACHE.get(key)
    if tpl is None:
        tpl = []
        for b in subbands.band_layout(H, W, levels):
            g_rev = subbands.band_gain(b.band, b.level, True)
            g_irr = subbands.band_gain(b.band, b.level, False)
            for (ty, tx, th, tw) in subbands.codeblock_tiles(b.h, b.w, cb):
                tpl.append((b, ty, tx, th, tw, g_rev, g_irr))
        _TEMPLATE_CACHE[key] = tpl
    return tpl


#: per-template empty EncodedBlock singletons: blocks are treated as
#: immutable everywhere, so the (overwhelmingly many) uncoded blocks of a
#: sparse frame can share one object per template slot instead of
#: constructing ~10^4 dataclasses per GOP on the host hot path.
_EMPTY_CACHE: Dict[Tuple[int, int, int, int], List["EncodedBlock"]] = {}


def _empty_blocks(H: int, W: int, levels: int, cb: int
                  ) -> List["EncodedBlock"]:
    key = (H, W, levels, cb)
    out = _EMPTY_CACHE.get(key)
    if out is None:
        out = [EncodedBlock(b.key, b.level, b.band, ty, tx, (th, tw),
                            0, b"", [], [])
               for (b, ty, tx, th, tw, _gr, _gi)
               in _tile_template(H, W, levels, cb)]
        _EMPTY_CACHE[key] = out
    return out


_DIMS_CACHE: Dict[Tuple[int, int, int, int], Tuple[np.ndarray, np.ndarray]] \
    = {}


def _tile_dims(H: int, W: int, levels: int, cb: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-template-tile true (th, tw) arrays for the device R-D sim."""
    key = (H, W, levels, cb)
    dims = _DIMS_CACHE.get(key)
    if dims is None:
        tpl = _tile_template(H, W, levels, cb)
        dims = (np.asarray([t[3] for t in tpl], np.int32),
                np.asarray([t[4] for t in tpl], np.int32))
        _DIMS_CACHE[key] = dims
    return dims


#: per-(H, W, levels, cb, N, device): :func:`_tile_dims` of N frames,
#: uploaded once (an upload waits for the device)
_DEVICE_DIMS_CACHE: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _tile_dims_on(H: int, W: int, levels: int, cb: int, N: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N * nb,) int32 true tile heights and widths on ``device``."""
    key = (H, W, levels, cb, N, torch.device(device))
    dims = _DEVICE_DIMS_CACHE.get(key)
    if dims is None:
        dims = tuple(torch.from_numpy(np.tile(d, N)).to(device)
                     for d in _tile_dims(H, W, levels, cb))
        _DEVICE_DIMS_CACHE[key] = dims
    return dims


def _to_int16(q: torch.Tensor):
    """(q as int16, a 0-dim bool set when some value does not fit)."""
    q16 = q.to(torch.int16)
    return q16, (q16.to(torch.int32) != q).any()


def _dwt_quant_tiles(plane: torch.Tensor, levels: int, reversible: bool,
                     delta: torch.Tensor, cb: int):
    """Forward DWT + quantize + code-block tiling.

    Returns (tiles, maxabs, overflow): ``tiles`` is (N, nb, cb, cb) int16
    in band-layout/template order (edge tiles zero-padded), ``maxabs`` the
    per-tile max magnitude, ``overflow`` a 0-dim bool that is set when a
    coefficient does not fit int16."""
    q16, overflow = _to_int16(_dwt_quant(plane, levels, reversible, delta))
    N, H, W = q16.shape
    parts = []
    for b in subbands.band_layout(H, W, levels):
        band = q16[:, b.y0:b.y0 + b.h, b.x0:b.x0 + b.w]
        nh, nw = -(-b.h // cb), -(-b.w // cb)
        band = F.pad(band, (0, nw * cb - b.w, 0, nh * cb - b.h))
        parts.append(band.reshape(N, nh, cb, nw, cb)
                     .permute(0, 1, 3, 2, 4).reshape(N, nh * nw, cb, cb))
    tiles = torch.cat(parts, dim=1)
    maxabs = tiles.to(torch.int32).abs().amax(dim=(2, 3))
    return tiles, maxabs, overflow


def _compact_tiles(tiles: torch.Tensor, maxabs: torch.Tensor,
                   smax: torch.Tensor, ms: torch.Tensor):
    """Block selection + stable compaction, without a host round trip.

    ``ms``: (N, nb) float32 per-tile slope floor.  Returns the tile stack
    reordered with the kept tiles first, in ascending flat-index order
    (``np.flatnonzero`` of the mask), and the boolean keep mask."""
    N, nb, cb, _ = tiles.shape
    keep = (maxabs > 0) & (smax >= ms)
    order = torch.argsort((~keep).reshape(-1).to(torch.uint8), stable=True)
    return tiles.reshape(N * nb, cb, cb)[order], keep


def _slope_floor(min_threshold, N: int, nb: int, tpl, reversible: bool,
                 delta: float, coder: str) -> np.ndarray:
    """(N, nb) float32 floor on the device smax for block selection.

    A block is kept iff its maximum achievable weighted slope (the first
    segment of its R-D hull, computed exactly on device for the bp coder)
    reaches the truncation threshold.  For the spec-MQ coder the bp byte
    counts are an upper bound on the MQ rate, so the criterion is relaxed
    by the MQ coder's plausible compaction margin (strictly conservative;
    MQ typically compacts the raw bp bits 2-4x, 32x margin is safe —
    pinned by test_sparse_selection_never_drops_surviving_blocks)."""
    thr = np.broadcast_to(np.asarray(min_threshold, np.float64), (N,))
    if not np.any(thr > 0):
        return np.zeros((N, nb), np.float32)
    margin = 1.0 if coder == "bp" else 32.0
    wts = np.empty(nb, np.float64)
    for i, (b, ty, tx, th, tw, g_rev, g_irr) in enumerate(tpl):
        wts[i] = g_rev if reversible else g_irr * float(delta) * float(delta)
    return (thr[:, None] / wts[None, :] / margin).astype(np.float32)


def _encode_device(planes: torch.Tensor, delta: torch.Tensor,
                   th: torch.Tensor, tw: torch.Tensor, ms: torch.Tensor,
                   levels: int, reversible: bool, cb: int):
    """The device half of stage 1, the JAX package's three jitted stages
    in a row: :func:`_dwt_quant_tiles`, ``bp_device.bp_max_slope`` and
    :func:`_compact_tiles`.  ``th``/``tw``: (N * nb,) true tile dims;
    ``ms``: (N, nb) slope floor.  Returns (compact, maxabs, keep,
    overflow)."""
    tiles, maxabs, ovf = _dwt_quant_tiles(planes, levels, reversible, delta,
                                          cb)
    N, nb = tiles.shape[0], tiles.shape[1]
    smax, _d0 = bp_device.bp_max_slope(tiles.reshape(N * nb, cb, cb), th,
                                       tw)
    compact, keep = _compact_tiles(tiles, maxabs, smax.reshape(N, nb), ms)
    return compact, maxabs, keep, ovf


#: :func:`_encode_device` as a captured program, per (N, H, W, levels,
#: reversible, cb); delta, tile dims and slope floor are its inputs
_encode_device_jit = graphs.captured(_encode_device)


def encode_frames_dispatch_sparse(planes: torch.Tensor, levels: int,
                                  reversible: bool, delta: float,
                                  codeblock_size: int, min_threshold=0.0,
                                  coder: str = "bp"):
    """Stage 1: DWT + quantize + tile, the bp R-D simulation and the
    threshold-driven block selection, all queued on the planes' device
    as one captured program.  ``planes``: (N, H, W) tensor."""
    dev = planes.device
    cb = codeblock_size
    N, H, W = planes.shape
    tpl = _tile_template(H, W, levels, cb)
    ms = _slope_floor(min_threshold, N, len(tpl), tpl, reversible,
                      float(delta), coder)
    # pageable copies: each waits for the work queued on the stream
    with trace.stage("texture_args_upload"):
        delta_dev = torch.tensor(delta, dtype=torch.float32, device=dev)
        ms_dev = torch.as_tensor(ms, device=dev)
    compact, maxabs, keep, ovf = _encode_device_jit(
        planes, delta_dev, *_tile_dims_on(H, W, levels, cb, N, dev),
        ms_dev, levels, reversible, cb)
    return (planes, compact, maxabs, keep, ovf, levels, reversible,
            float(delta), cb)


def encode_frames_select_sparse(pending, min_threshold, coder: str = "bp",
                                stats=None):
    """Stage 2: turn the per-tile stats into host bookkeeping and slice
    the kept prefix of the compacted stack.

    ``min_threshold`` and ``coder`` are the JAX function's (the slope
    floor was applied at dispatch).  ``stats``: the host values of the
    pending ``(maxabs, keep, ovf)`` if the caller has fetched them (the
    pipelined encode fetches both stacks' at once); None fetches them
    here."""
    (pl, compact, maxabs, keep, ovf, levels, reversible, d, cb) = pending
    if stats is None:
        stats = tuple(t.cpu().numpy() for t in (maxabs, keep, ovf))
    maxabs_h, keep_h, ovf_h = stats
    if bool(ovf_h):
        dt = torch.tensor(d, dtype=torch.float32, device=pl.device)
        packed = _dwt_quant(pl, levels, reversible, dt).cpu().numpy()
        return ("packed", packed, None, None, levels, reversible, float(d),
                cb)
    N, nb = maxabs_h.shape
    flat_idx = np.flatnonzero(keep_h.ravel()).astype(np.int32)
    return ("sparse", compact[:len(flat_idx)], flat_idx, (N, nb, maxabs_h),
            levels, reversible, float(d), cb)


def encode_frames_finish_sparse(selected, H: int, W: int,
                                min_threshold, coder: str
                                ) -> List[EncodedFrame]:
    """Stage 3: fetch compact tiles, run the native coder on them only.

    ``min_threshold``: scalar or per-frame (N,) array (see select stage).
    """
    (mode, data, flat_idx, stats, levels, reversible, delta, cb) = selected
    if mode == "packed":
        return encode_frames_host(data, levels, reversible, delta, cb,
                                  min_threshold, coder)
    # (kb, cb, cb) int16; trim the bucketed prefix to the true count
    compact = np.asarray(data)[:len(flat_idx)]
    N, nb, maxabs_h = stats
    thr = np.broadcast_to(np.asarray(min_threshold, np.float64), (N,))
    any_thr = bool(np.any(thr > 0))
    tpl = _tile_template(H, W, levels, cb)
    K = compact.shape[0]
    tiles_meta: List[Tuple] = []
    bands: List[str] = []
    min_slopes: List[float] = []
    metas: List[Tuple] = []
    for k, fi in enumerate(flat_idx):
        n, ti = divmod(int(fi), nb)
        (b, ty, tx, th, tw, g_rev, g_irr) = tpl[ti]
        w = g_rev if reversible else g_irr * delta * delta
        tiles_meta.append((k, 0, 0, th, tw))
        bands.append(b.band)
        min_slopes.append(thr[n] / w / 8.0 if thr[n] > 0 else 0.0)
        metas.append((n, b, ty, tx, th, tw, w))
    encoded = fast.encode_packed_planes(
        compact, tiles_meta, bands,
        min_slopes if any_thr else None, coder=coder)
    per_frame: List[List[EncodedBlock]] = [[] for _ in range(N)]
    coded = {}
    for cbk, (n, b, ty, tx, th, tw, w) in zip(encoded, metas):
        slopes = _hull_slopes(cbk.pass_ends, cbk.pass_dist, cbk.dist0, w)
        coded[(n, b.key, ty, tx)] = EncodedBlock(
            b.key, b.level, b.band, ty, tx, (th, tw), cbk.msbs,
            cbk.data, cbk.pass_ends, slopes)
    empties = _empty_blocks(H, W, levels, cb)
    for n in range(N):
        for ti, (b, ty, tx, th, tw, g_rev, g_irr) in enumerate(tpl):
            blk = coded.get((n, b.key, ty, tx))
            per_frame[n].append(empties[ti] if blk is None else blk)
    return [EncodedFrame(H, W, levels, reversible, delta, cb, blocks, coder)
            for blocks in per_frame]


def encode_frames_dispatch(planes, levels: int, reversible: bool,
                           delta: float, *, device="cuda"):
    """Stage 1 of the dense encode: the DWT + quantization of a stack of
    planes (N, H, W), a numpy array or a tensor, queued on ``device``
    without waiting for it.  Returns an opaque pending handle for
    :func:`encode_frames_fetch`."""
    if not isinstance(planes, torch.Tensor):
        planes = torch.from_numpy(np.ascontiguousarray(planes))
    d = torch.tensor(delta, dtype=torch.float32, device=device)
    q = _dwt_quant(planes.to(device), levels, reversible, d)
    return (q,) + _to_int16(q)


def encode_frames_fetch(pending) -> np.ndarray:
    """Stage 2: the quantized planes on the host, as int16, or as int32
    when a quantized index does not fit int16."""
    q, q16, overflow = pending
    return (q if bool(overflow) else q16).cpu().numpy()


def encode_frames_host(packed_all: np.ndarray, levels: int, reversible: bool,
                       delta: float, codeblock_size: int,
                       min_threshold, coder: str
                       ) -> List[EncodedFrame]:
    """Stage 3: native entropy coding of fetched planes (CPU-bound)."""
    N, H, W = packed_all.shape
    thr = np.broadcast_to(np.asarray(min_threshold, np.float64), (N,))
    any_thr = bool(np.any(thr > 0))
    tpl = _tile_template(H, W, levels, codeblock_size)
    tiles_meta: List[Tuple] = []
    bands: List[str] = []
    meta: List[Tuple] = []
    min_slopes: List[float] = []
    for n in range(N):
        for (b, ty, tx, th, tw, g_rev, g_irr) in tpl:
            w = g_rev if reversible else g_irr * delta * delta
            tiles_meta.append((n, b.y0 + ty, b.x0 + tx, th, tw))
            bands.append(b.band)
            meta.append((n, b, ty, tx, th, tw, w))
            min_slopes.append(thr[n] / w / 8.0 if thr[n] > 0 else 0.0)
    encoded = fast.encode_packed_planes(packed_all, tiles_meta, bands,
                                        min_slopes if any_thr
                                        else None, coder=coder)
    per_frame: List[List[EncodedBlock]] = [[] for _ in range(N)]
    for cb, (n, b, ty, tx, th, tw, w) in zip(encoded, meta):
        slopes = _hull_slopes(cb.pass_ends, cb.pass_dist, cb.dist0, w)
        per_frame[n].append(EncodedBlock(
            b.key, b.level, b.band, ty, tx, (th, tw), cb.msbs,
            cb.data, cb.pass_ends, slopes))
    return [EncodedFrame(H, W, levels, reversible, delta, codeblock_size,
                         blocks, coder) for blocks in per_frame]

def _scatter_tiles(tiles: torch.Tensor, pos: torch.Tensor,
                   N: int, H: int, W: int) -> torch.Tensor:
    """Scatter decoded (K, cb, cb) code-block tiles into a zero (N, H, W)
    packed plane stack.  Padding rows and columns of edge tiles that fall
    past the plane are masked out; those that fall inside land in the
    neighbouring band as ``+= 0`` (accumulate, never overwrite)."""
    K, cb, _ = tiles.shape
    ar = torch.arange(cb, device=tiles.device)
    iN = pos[:, 0, None, None].expand(K, cb, cb)
    iY = (pos[:, 1, None, None] + ar[None, :, None]).expand(K, cb, cb)
    iX = (pos[:, 2, None, None] + ar[None, None, :]).expand(K, cb, cb)
    inside = (iY < H) & (iX < W)
    packed = torch.zeros((N, H, W), dtype=tiles.dtype, device=tiles.device)
    packed.index_put_((iN, iY.clamp(max=H - 1), iX.clamp(max=W - 1)),
                      torch.where(inside, tiles, 0), accumulate=True)
    return packed


def encode_frames(planes, levels: int, reversible: bool = True,
                  delta: float = 0.125, codeblock_size: int = 64,
                  min_threshold: float = 0.0, coder: str = "mq", *,
                  device="cuda") -> List[EncodedFrame]:
    """Encode a stack of component planes (N, H, W), a numpy array or a
    tensor, on ``device``: one DWT+quantize+R-D pass, one native batch
    over the kept code-blocks of all frames.  The serial wrapper of the
    dispatch / select / finish stages that :mod:`..api` pipelines."""
    if not isinstance(planes, torch.Tensor):
        planes = torch.from_numpy(np.ascontiguousarray(planes))
    planes = planes.to(device)
    pending = encode_frames_dispatch_sparse(planes, levels, reversible,
                                            delta, codeblock_size,
                                            min_threshold, coder)
    selected = encode_frames_select_sparse(pending, min_threshold, coder)
    if isinstance(selected[1], torch.Tensor):
        selected = selected[:1] + (selected[1].cpu().numpy(),) + selected[2:]
    H, W = planes.shape[1], planes.shape[2]
    return encode_frames_finish_sparse(selected, H, W, min_threshold, coder)


def decode_frames(efs: List[EncodedFrame], threshold: float = 0.0,
                  discard_levels: int = 0, to_host: bool = True, *,
                  device="cuda"):
    """Decode a stack of same-geometry frames with ONE native batch
    entropy decode and ONE dequantize+inverse-DWT pass on ``device``;
    returns (N, H', W') int32: a host numpy array, or with
    ``to_host=False`` a tensor on ``device`` (the decode path's inverse
    MCTF takes it as it is).

    ``discard_levels = d`` drops the ``d`` finest resolution levels (SS):
    their detail blocks are skipped and the result has the geometry of
    the d-times reduced image (the LL_d band).

    Only the coded code-block tiles cross to the device when they cover
    under half of the planes (at lossy operating points the packed
    planes are almost all zeros); otherwise the planes are decoded into
    a dense host stack and uploaded whole."""
    if not efs:
        if to_host:
            return np.zeros((0, 0, 0), np.int32)
        return torch.zeros((0, 0, 0), dtype=torch.int32, device=device)
    ef0 = efs[0]
    H, W, levels = ef0.H, ef0.W, ef0.levels
    by_key = {}
    for b in subbands.band_layout(H, W, levels):
        by_key.setdefault(b.key, b)
    todo = []
    positions = []
    with trace.stage("decode.todo"):
        for n, ef in enumerate(efs):
            for blk in ef.blocks:
                if blk.level <= discard_levels and blk.band != "LL":
                    continue
                np_ = (blk.num_passes if threshold <= 0
                       else blk.passes_for_threshold(threshold))
                if np_ == 0 or not blk.data:
                    continue        # decodes to zeros: nothing to do
                todo.append((blk.data, blk.msbs, np_, blk.shape, blk.band,
                             blk.pass_ends))
                b = by_key[blk.band_key]
                positions.append((n, b.y0 + blk.y0, b.x0 + blk.x0))

    Hd = dwt2d._level_sizes(H, discard_levels)[-1]
    Wd = dwt2d._level_sizes(W, discard_levels)[-1]
    coded_area = sum(b[3][0] * b[3][1] for b in todo)
    d = torch.tensor(ef0.delta, dtype=torch.float32, device=device)
    if coded_area * 2 < len(efs) * H * W:
        with trace.stage("decode.native", blocks=len(todo)):
            if ef0.coder == "bp":
                tiles = fast.bp_decode_tiles([(b[0], b[1], b[2], b[3])
                                              for b in todo])
            else:
                tiles = fast.decode_codeblocks_batch(todo)
        with trace.stage("decode.pack"):
            cb = max((max(b[3]) for b in todo), default=1)
            tile_arr = np.zeros((len(todo), cb, cb), np.int32)
            for i, (b, t) in enumerate(zip(todo, tiles)):
                th, tw = b[3]
                tile_arr[i, :th, :tw] = t
            pos = np.asarray(positions, np.int64).reshape(-1, 3)
        with trace.stage("decode.dispatch", tiles=len(todo)):
            packed = _scatter_tiles(torch.from_numpy(tile_arr).to(device),
                                    torch.from_numpy(pos).to(device),
                                    len(efs), Hd, Wd)
    else:
        with trace.stage("decode.native", blocks=len(todo), dense=True):
            dense = np.zeros((len(efs), H, W), np.int32)
            fast.decode_packed_planes(todo, positions, dense,
                                      coder=ef0.coder)
        packed = torch.from_numpy(
            np.ascontiguousarray(dense[:, :Hd, :Wd])).to(device)
    with trace.stage("decode.idwt_dispatch"):
        out = _dequant_idwt_jit(packed, levels - discard_levels,
                                ef0.reversible, d)
    return out.cpu().numpy() if to_host else out


def encode_frame(plane, levels: int, reversible: bool = True,
                 delta: float = 0.125, codeblock_size: int = 64,
                 min_threshold: float = 0.0, coder: str = "mq", *,
                 device="cuda") -> EncodedFrame:
    """Encode one component plane (uint8-range values) on ``device``.

    ``min_threshold``: weighted-slope floor — planes whose distortion-length
    slope falls well below it are never coded (they cannot survive
    truncation at that threshold), which skips most deep bit-planes at
    lossy operating points."""
    stack = plane if isinstance(plane, torch.Tensor) else np.asarray(plane)
    return encode_frames(stack[None], levels, reversible, delta, codeblock_size,
                         min_threshold, coder, device=device)[0]


def decode_frame(ef: EncodedFrame, threshold: float = 0.0,
                 discard_levels: int = 0, *, device="cuda") -> np.ndarray:
    """Decode one frame on ``device``, optionally truncating by slope
    threshold (QS) and discarding the finest ``discard_levels``
    resolution levels (SS); with ``discard_levels = d`` the (H', W') int32
    host plane has the dimensions of the d-times-reduced image."""
    return decode_frames([ef], threshold, discard_levels, device=device)[0]
