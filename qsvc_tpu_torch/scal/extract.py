"""Scalable stream extraction: quality (QS), spatial (SS), temporal (TS)
and rate-controlled (BRC) truncation — without re-encoding.

Copy of ``qsvc_tpu/scal/extract.py`` (host code over the container; the
same bytes for the same stream).

The reference implements this in ``transcode.py`` (2273 LoC) by repeatedly
invoking ``kdu_transcode`` and *fully re-decoding* each rate-distortion
probe (``lba()``, transcode.py:535-790).  Here every code-block pass
already carries its distortion-length slope (recorded at encode time), so:

* **QS**: truncate every block at a slope threshold, or keep the first
  ``clayers`` quality layers (layer k of subband s = passes with slope >=
  T(u_s + (nLayers-1-k)*step), the per-subband slope rows of
  ``texture_compress.py:148-176``);
* **SS**: drop the finest ``discard_SRLs`` resolution levels of every
  frame — dimensions, block size and motion vectors halve per level
  (the reference's ``-reduce`` + scaled-parameter decode,
  transcode.py:558-582, tests/MCJ2K-compress-extract-expand.sh);
* **TS**: drop the finest ``discard_TRLs`` temporal levels — frame rate
  halves per level (the extracted stream is a smaller standalone MCTF
  stream);
* **BRC**: hit a byte budget with one of the reference's ordering
  policies — FS (globally R-D-optimal greedy over recorded slopes,
  replacing ``BRC_BruteForce``, transcode.py:1307-1489), PTS
  (progressive by temporal subband, :804/:886), PTL (progressive by
  quality layer, :959), AmPTL (gain-weighted layer interleave, :1029).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..config import CodecConfig, GAINS
from ..codec import codestream
from ..codec.codestream import LevelSection, VideoStream
from ..codec.frame_codec import (EncodedBlock, EncodedFrame,
                                 slope_to_threshold)


# ------------------------------------------------------------------ QS

def _subband_rows(cfg: CodecConfig) -> List[List[int]]:
    return cfg.slopes()


def _layer_threshold(cfg: CodecConfig, row: int, clayers: int) -> float:
    """Slope threshold keeping the first ``clayers`` layers of subband
    ``row`` (row 0 = L, row s = H_{TRLs-s})."""
    rows = _subband_rows(cfg)
    vals = rows[row]
    n = len(vals)
    step = vals[1] - vals[0] if n > 1 else 0
    k = max(1, min(clayers, n))
    u = vals[0] + step * (n - k)
    return slope_to_threshold(u)


def quality_truncate(vs: VideoStream, quantization: float = 0.0,
                     clayers: int = 0) -> VideoStream:
    """QS extraction: uniform slope threshold and/or per-subband layers."""
    cfg = vs.cfg

    def trunc_frames(frames, row):
        thr = 0.0
        if clayers:
            thr = _layer_threshold(cfg, row, clayers)
        if quantization:
            thr = max(thr, slope_to_threshold(quantization))
        if thr <= 0:
            return frames
        return [{c: ef.truncate(thr) for c, ef in fr.items()}
                for fr in frames]

    low = trunc_frames(vs.low, 0)
    levels = []
    for t, lev in enumerate(vs.levels, start=1):
        high = trunc_frames(lev.high, cfg.TRLs - t)
        levels.append(LevelSection(high, lev.motion, lev.frame_types))
    return VideoStream(cfg, vs.reversible, vs.delta, low, levels,
                       true_dims=vs.true_dims, true_frames=vs.true_frames)


# ------------------------------------------------------------------ TS

def temporal_truncate(vs: VideoStream, discard_TRLs: int) -> VideoStream:
    """TS extraction: drop the finest temporal levels; the result is a
    standalone stream at 1/2**d frame rate with rescaled level params."""
    if discard_TRLs <= 0:
        return vs
    cfg = vs.cfg
    d = min(discard_TRLs, cfg.TRLs - 1)
    sched = cfg.level_schedule()
    new_trls = cfg.TRLs - d
    new_cfg = cfg.replace(
        TRLs=new_trls,
        block_size=sched[d].block_size if new_trls > 1 else cfg.auto_block_size,
        block_size_min=min(cfg.auto_block_size_min,
                           sched[d].block_size if new_trls > 1 else
                           cfg.auto_block_size),
        search_range=sched[d].search_range if new_trls > 1 else
        cfg.search_range)
    return VideoStream(
        new_cfg, vs.reversible, vs.delta, vs.low, vs.levels[d:],
        true_dims=vs.true_dims,
        # frames surviving at 1/2**d rate are those at indices k*2**d
        true_frames=((vs.true_frames - 1) // 2 ** d + 1
                     if vs.true_frames is not None else None))


# ------------------------------------------------------------------ SS

def _reduce_frame(ef: EncodedFrame, d: int) -> EncodedFrame:
    """Drop the ``d`` finest resolution levels of one encoded frame."""
    sizes_h = [ef.H]
    sizes_w = [ef.W]
    for _ in range(max(ef.levels, d)):
        sizes_h.append(max(sizes_h[-1] >> 1, 1))
        sizes_w.append(max(sizes_w[-1] >> 1, 1))
    keep = []
    for b in ef.blocks:
        if b.band != "LL" and b.level <= d:
            continue
        keep.append(EncodedBlock(
            f"{b.band}{b.level - d}" if b.band != "LL" else
            f"LL{ef.levels - d}",
            b.level - d if b.band != "LL" else ef.levels - d,
            b.band, b.y0, b.x0, b.shape, b.msbs, b.data, b.pass_ends,
            b.pass_slopes))
    return EncodedFrame(sizes_h[d], sizes_w[d], ef.levels - d,
                        ef.reversible, ef.delta, ef.codeblock_size, keep,
                        ef.coder)


def spatial_truncate(vs: VideoStream, discard_SRLs: int) -> VideoStream:
    """SS extraction: halve spatial resolution ``d`` times.  Motion vectors
    are decoded, scaled by 1/2**d (truncating, like the reference's
    subpixel-domain halving) and re-coded; block size and frame dims halve.
    """
    if discard_SRLs <= 0:
        return vs
    from ..codec import backends as _bk
    if vs.low and isinstance(vs.low[0]["y"], _bk.BackendFrame):
        raise ValueError("SS extraction requires the internal texture "
                         "codec (alternative backends carry no "
                         "resolution-level structure; same limitation "
                         "as the reference's non-J2K codecs)")
    cfg = vs.cfg
    d = min(discard_SRLs, cfg.SRLs - 1)

    def reduce_frames(frames):
        return [{c: _reduce_frame(ef, d) for c, ef in fr.items()}
                for fr in frames]

    low = reduce_frames(vs.low)
    levels = []
    for lev in vs.levels:
        high = reduce_frames(lev.high)
        motion = []
        for m in lev.motion:
            f = codestream.decode_motion_field(m)
            f = np.sign(f) * (np.abs(f) >> d)      # truncating halving
            motion.append(codestream.encode_motion_field(f.astype(np.int64)))
        levels.append(LevelSection(high, motion, lev.frame_types))
    new_cfg = cfg.replace(
        pixels_in_x=max(cfg.pixels_in_x >> d, 1),
        pixels_in_y=max(cfg.pixels_in_y >> d, 1),
        block_size=max(cfg.auto_block_size >> d, 1),
        block_size_min=max(cfg.auto_block_size_min >> d, 1),
        search_range=max(cfg.search_range >> d, 1),
        SRLs=cfg.SRLs - d)
    return VideoStream(
        new_cfg, vs.reversible, vs.delta, low, levels,
        true_dims=((max(-(-vs.true_dims[0] >> d), 1),     # ceil(dim/2^d)
                    max(-(-vs.true_dims[1] >> d), 1))
                   if vs.true_dims is not None else None),
        true_frames=vs.true_frames)


# ------------------------------------------------------------------ BRC

def _all_increments(vs: VideoStream):
    """Flatten every (block, pass) increment with location metadata.

    Yields ``(subband_row, slope, nbytes, block, pass_idx, gop)`` where
    subband_row 0 = L, s = H_{TRLs-s} (texture only; motion and headers
    count as mandatory overhead) and ``gop`` is the GOP a frame belongs
    to (frame index scaled by the level's pair stride — the per-GOP
    algorithms SR/ISR allocate within GOPs, transcode.py:2102-2160).
    """
    cfg = vs.cfg
    out = []

    def walk(frames, row, pairs_per_gop):
        for fi, fr in enumerate(frames):
            gop = fi // pairs_per_gop if pairs_per_gop else 0
            for comp, ef in fr.items():
                for blk in ef.blocks:
                    prev = 0
                    for p, (end, s) in enumerate(zip(blk.pass_ends,
                                                     blk.pass_slopes)):
                        out.append((row, s, end - prev, blk, p, gop))
                        prev = end

    walk(vs.low, 0, 1)
    for t, lev in enumerate(vs.levels, start=1):
        # level t (finest=1) holds gop_size/2**t frame pairs per GOP
        walk(lev.high, cfg.TRLs - t, max(cfg.gop_size >> t, 1))
    return out


def _apply_selection(vs: VideoStream, keep_passes: Dict[int, int]
                     ) -> VideoStream:
    """Rebuild the stream keeping ``keep_passes[id(block)]`` passes."""
    def rebuild(frames):
        out = []
        for fr in frames:
            nf = {}
            for comp, ef in fr.items():
                blocks = []
                for blk in ef.blocks:
                    n = keep_passes.get(id(blk), 0)
                    end = blk.pass_ends[n - 1] if n else 0
                    blocks.append(EncodedBlock(
                        blk.band_key, blk.level, blk.band, blk.y0, blk.x0,
                        blk.shape, blk.msbs, blk.data[:end],
                        blk.pass_ends[:n], blk.pass_slopes[:n]))
                nf[comp] = EncodedFrame(ef.H, ef.W, ef.levels,
                                        ef.reversible, ef.delta,
                                        ef.codeblock_size, blocks, ef.coder)
            out.append(nf)
        return out

    low = rebuild(vs.low)
    levels = [LevelSection(rebuild(lev.high), lev.motion, lev.frame_types)
              for lev in vs.levels]
    return VideoStream(vs.cfg, vs.reversible, vs.delta, low, levels,
                       true_dims=vs.true_dims, true_frames=vs.true_frames)


def _greedy_ordered(incs, budget: int, keep: Dict[int, int],
                    skip_over_budget: bool) -> int:
    """Walk pre-ordered increments, keeping causal pass prefixes per block
    until ``budget`` bytes are spent.  Returns bytes spent."""
    spent = 0
    for row, slope, nbytes, blk, p, gop in incs:
        # a pass can only be kept if all earlier passes of its block are
        if keep.get(id(blk), 0) != p:
            continue
        if spent + nbytes > budget:
            if skip_over_budget:
                continue     # try later (smaller) increments
            break
        keep[id(blk)] = p + 1
        spent += nbytes
    return spent


def select_for_rate(vs: VideoStream, budget_bytes: int,
                    algorithm: str = "FS") -> VideoStream:
    """Rate-controlled extraction: pick pass increments to fit a byte
    budget under a given ordering policy.

    Global orderings (whole video at once):

    * ``FS``   — globally R-D-optimal greedy over recorded slopes (the
      steepest-slope search of ``BRC_BruteForce``, transcode.py:1307-1489,
      without the decode probes);
    * ``PTS``  — progressive by temporal subband, L first then coarse->fine
      H (``for_Subbands__rmse_low0``, transcode.py:886);
    * ``ITS``  — subband-progressive like PTS but the H order is *measured*
      per stream (subbands sorted by recorded distortion-per-byte benefit,
      the data-driven ordering of ``MCJ2K_for_Subbands__rmse_lowx``,
      transcode.py:804);
    * ``PTL``  — progressive by quality layer, layers interleaved across
      subbands (``for_Layers``, transcode.py:959);
    * ``AmPTL``— gain-weighted layer interleave (``Gains_Layers``,
      transcode.py:1029).

    Per-GOP orderings (budget shared per GOP, transcode.py:2102-2160):

    * ``SR``   — within each GOP, advance one whole (subband, pass-rank)
      step at a time, choosing the step with the best aggregate slope from
      the previous point (``OneSub_ForAll_PtAnterior``, transcode.py:1490);
    * ``ISR``  — subbands treated independently within each GOP: a common
      slope threshold is bisected so the per-GOP total fits the share
      (``Sub_Independents``, transcode.py:1623).
    """
    cfg = vs.cfg
    incs = _all_increments(vs)
    mandatory = sum(sum(len(dd) for dd, _, _ in m["parts"])
                    for lev in vs.levels for m in lev.motion)
    budget = max(budget_bytes - mandatory, 0)

    gains = ([1.0] + list(reversed(GAINS.get(cfg.TRLs, [1.0]))))  # row-index

    if algorithm in ("SR", "ISR"):
        return _apply_selection(vs, _select_per_gop(incs, budget, algorithm))

    if algorithm == "ITS":
        # measured subband order: average recorded slope per byte, L first
        mass: Dict[int, List[float]] = {}
        for row, slope, nbytes, blk, p, gop in incs:
            b, d = mass.setdefault(row, [0.0, 0.0])
            mass[row][0] += nbytes
            mass[row][1] += slope * nbytes
        rank = {row: (0 if row == 0 else 1,
                      -(v[1] / v[0] if v[0] else 0.0))
                for row, v in mass.items()}

    def order_key(item):
        row, slope, nbytes, blk, p, gop = item
        if algorithm == "FS":
            return (-slope,)
        if algorithm == "PTS":
            # subband-progressive: L fully first, then coarse H -> fine H
            return (row, -slope)
        if algorithm == "ITS":
            return (rank[row], -slope)
        if algorithm == "PTL":
            # layer-progressive: interleave by layer rank (pass index as a
            # proxy for layer), then slope
            return (p, row, -slope)
        if algorithm == "AmPTL":
            g = gains[row] if row < len(gains) else 1.0
            return (p / max(g, 1e-9), -slope)
        raise ValueError(f"unknown algorithm {algorithm}")

    incs.sort(key=order_key)
    keep: Dict[int, int] = {}
    _greedy_ordered(incs, budget, keep, skip_over_budget=(algorithm == "FS"))
    return _apply_selection(vs, keep)


def _select_per_gop(incs, budget: int, algorithm: str) -> Dict[int, int]:
    """Per-GOP budget allocation (SR / ISR policies)."""
    by_gop: Dict[int, list] = {}
    for item in incs:
        by_gop.setdefault(item[5], []).append(item)
    ngops = max(len(by_gop), 1)
    keep: Dict[int, int] = {}
    share = budget // ngops
    carry = budget - share * ngops          # leftover bytes ride along
    for gop in sorted(by_gop):
        items = by_gop[gop]
        b = share + carry
        if algorithm == "SR":
            spent = _select_sr(items, b, keep)
        else:
            spent = _select_isr(items, b, keep)
        carry = b - spent
    return keep


def _select_sr(items, budget: int, keep: Dict[int, int]) -> int:
    """Greedy (subband, pass-rank) steps by aggregate slope."""
    # aggregate each (row, p) step: total bytes + byte-weighted slope
    steps: Dict[Tuple[int, int], List] = {}
    for row, slope, nbytes, blk, p, gop in items:
        st = steps.setdefault((row, p), [0.0, 0.0, []])
        st[0] += nbytes
        st[1] += slope * nbytes
        st[2].append((blk, p, nbytes))
    # order: per subband the pass ranks are causal; across subbands pick
    # best aggregate slope first, never skipping a rank within a subband
    by_row: Dict[int, List[Tuple[int, float, float, list]]] = {}
    for (row, p), (nb, sw, blks) in steps.items():
        by_row.setdefault(row, []).append((p, nb, sw / max(nb, 1e-12), blks))
    for row in by_row:
        by_row[row].sort()
    cursor = {row: 0 for row in by_row}
    spent = 0
    while True:
        best = None
        for row, lst in by_row.items():
            c = cursor[row]
            if c >= len(lst):
                continue
            p, nb, s, blks = lst[c]
            if best is None or s > best[1]:
                best = (row, s, nb, blks)
        if best is None:
            break
        row, s, nb, blks = best
        if spent + nb > budget:
            break
        for blk, p, nbytes in blks:
            if keep.get(id(blk), 0) == p:
                keep[id(blk)] = p + 1
        spent += nb
        cursor[row] += 1
    return spent


def _select_isr(items, budget: int, keep: Dict[int, int]) -> int:
    """Common-slope-threshold bisection, subbands independent."""
    slopes = sorted({s for _, s, _, _, _, _ in items}, reverse=True)

    def spend_at(thr: float) -> int:
        total = 0
        prefix: Dict[int, int] = {}
        for row, slope, nbytes, blk, p, gop in items:
            if slope >= thr and prefix.get(id(blk), -1) == p - 1:
                prefix[id(blk)] = p
                total += nbytes
        return total

    # bisect over the discrete slope set (largest threshold whose cost fits)
    lo, hi = 0, len(slopes) - 1
    best_thr = None
    while lo <= hi:
        mid = (lo + hi) // 2
        if spend_at(slopes[mid]) <= budget:
            best_thr = slopes[mid]
            lo = mid + 1
        else:
            hi = mid - 1
    if best_thr is None:
        return 0
    spent = 0
    prefix: Dict[int, int] = {}
    for row, slope, nbytes, blk, p, gop in items:
        causal = (p == 0 or prefix.get(id(blk), -1) == p - 1)
        if slope >= best_thr and causal:
            prefix[id(blk)] = p
            n0 = keep.get(id(blk), 0)
            if n0 == p:
                keep[id(blk)] = p + 1
            spent += nbytes
    return spent


# ------------------------------------------------------------------ driver

def transcode(vs: VideoStream, quantization: float = 0.0, clayers: int = 0,
              discard_TRLs: int = 0, discard_SRLs: int = 0,
              algorithm: str = "PTS", BRC: float = 0.0,
              fps: float = 30.0) -> VideoStream:
    """The ``mctf transcode`` equivalent (transcode.py:2070-2160 dispatch)."""
    out = vs
    if discard_TRLs:
        out = temporal_truncate(out, discard_TRLs)
    if discard_SRLs:
        out = spatial_truncate(out, discard_SRLs)
    if quantization or clayers:
        out = quality_truncate(out, quantization, clayers)
    if BRC:
        pictures = out.cfg.pictures
        seconds = pictures / fps
        budget = int(BRC * 1000.0 / 8.0 * seconds)
        out = select_for_rate(out, budget, algorithm)
    return out
