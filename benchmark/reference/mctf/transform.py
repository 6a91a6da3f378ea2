"""The full MCTF temporal transform: analyze (encode) and synthesize
(decode).

Frozen copy of ``qsvc_tpu_torch/mctf/transform.py``: per level, split -> motion
estimation -> predict -> update, and the inverse un-update -> correlate
-> merge, with the level schedule of ``CodecConfig.level_schedule()``.
Frame pairs form the leading batch axis.  All arithmetic runs in int16
(pixels, 4:4:4 interpolations, residues and update contributions stay
below 2^10 in magnitude); SAD sums and update accumulations widen to
int32 inside the steps.  Every step runs its plain PyTorch version,
on whatever device the planes are on.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import CodecConfig
from . import me, predict, update

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class LevelData(NamedTuple):
    """Encoded data of one temporal level ``t``."""
    high_y: torch.Tensor   # (P, H, W) biased residue / raw I frames
    high_u: torch.Tensor   # (P, H/2, W/2)
    high_v: torch.Tensor
    mv: torch.Tensor       # (P, 2, 2, By, Bx) motion (0 for I frames)
    is_B: torch.Tensor     # (P,) bool frame types


class MCTFStream(NamedTuple):
    """Full temporal decomposition of a sequence."""
    low_y: torch.Tensor    # final low band L_{TRLs-1}
    low_u: torch.Tensor
    low_v: torch.Tensor
    levels: Tuple[LevelData, ...]   # level 1 (finest) .. TRLs-1

    @classmethod
    def from_numpy(cls, stream, *, device="cuda") -> "MCTFStream":
        """Convert any stream with these fields (numpy arrays, or the JAX
        package's ``MCTFStream``) into torch tensors on ``device``."""
        def t(a):
            return torch.from_numpy(np.array(a)).to(device)
        return cls(t(stream.low_y), t(stream.low_u), t(stream.low_v),
                   tuple(LevelData(*(t(a) for a in lev))
                         for lev in stream.levels))

    def to_numpy(self) -> "MCTFStream":
        """The same stream with numpy arrays in place of tensors."""
        def n(a):
            return a.cpu().numpy()
        return MCTFStream(n(self.low_y), n(self.low_u), n(self.low_v),
                          tuple(LevelData(*(n(a) for a in lev))
                                for lev in self.levels))


def _update_evens(evens444: torch.Tensor, res444: torch.Tensor,
                  mv: torch.Tensor, block_size: int, search_range: int,
                  cfg: CodecConfig, sign: int) -> torch.Tensor:
    """Both update phases on a level's 4:4:4 evens (returns a new tensor):
    phase 1 adds to even[j] the NEXT update of pair j-1, phase 2 the PREV
    update of pair j, each truncating and clamping (``sign`` -1 undoes
    them).  The sharded MCTF passes its own, with halo exchanges between
    the phases (``parallel/transform.py``)."""
    upd_prev, upd_next = update.update_fields_batch2(
        res444, mv, block_size, cfg.update_factor, search_range)
    ev444 = evens444.clone()
    ev444[1:] = update.apply_update(ev444[1:], upd_next, sign)
    ev444[:-1] = update.apply_update(ev444[:-1], upd_prev, sign)
    return ev444


def _analyze_level(low: Planes, block_size: int, search_range: int,
                   cfg: CodecConfig, update_evens=_update_evens
                   ) -> Tuple[Planes, LevelData]:
    y, u, v = low
    ey, eu, ev = (p[0::2].contiguous() for p in (y, u, v))
    oy, ou, ov = (p[1::2].contiguous() for p in (y, u, v))

    mv = me.estimate_sequence(ey, oy, block_size, search_range,
                              cfg.border_size, cfg.subpixel_accuracy)
    evens444 = predict.refs_to_444_batch((ey, eu, ev))
    preds = predict.predict_frames_subpixel_evens(
        evens444, mv, block_size, search_range, cfg.subpixel_accuracy,
        cfg.block_overlaping)
    dec = predict.decorrelate_from_preds((oy, ou, ov), preds, mv,
                                         cfg.always_B)
    del preds

    if cfg.update_factor != 0.0:
        res444 = update.residues_to_444(
            (dec.high_y, dec.high_u, dec.high_v), dec.is_B)
        # the update moves whole pixels: sub-pixel vectors shift down by
        # the accuracy (arithmetic, so floor), here and not in
        # update_evens, so that the sharded MCTF's update gets it too
        ev444 = update_evens(evens444, res444,
                             dec.mv_out >> cfg.subpixel_accuracy,
                             block_size, search_range, cfg, 1)
        ly = ev444[:, 0]
        lu = predict.downsample_chroma(ev444[:, 1])
        lv = predict.downsample_chroma(ev444[:, 2])
    else:
        ly, lu, lv = ey, eu, ev
    return (ly, lu, lv), LevelData(dec.high_y, dec.high_u, dec.high_v,
                                   dec.mv_out, dec.is_B)


def _synthesize_level(low: Planes, lev: LevelData, block_size: int,
                      search_range: int, cfg: CodecConfig,
                      update_evens=_update_evens) -> Planes:
    low444 = predict.refs_to_444_batch(low)
    if cfg.update_factor != 0.0:
        res444 = update.residues_to_444(
            (lev.high_y, lev.high_u, lev.high_v), lev.is_B)
        ev444 = update_evens(low444, res444,
                             lev.mv >> cfg.subpixel_accuracy, block_size,
                             search_range, cfg, -1)
    else:
        ev444 = low444

    preds = predict.predict_frames_subpixel_evens(
        ev444, lev.mv, block_size, search_range, cfg.subpixel_accuracy,
        cfg.block_overlaping)
    odd = predict.correlate_from_preds(
        (lev.high_y, lev.high_u, lev.high_v), preds, lev.is_B)
    even = (ev444[:, 0], predict.downsample_chroma(ev444[:, 1]),
            predict.downsample_chroma(ev444[:, 2]))

    def merge(e, o):                      # re-interleave (split inverse)
        out = e.new_zeros((e.shape[0] + o.shape[0],) + e.shape[1:])
        out[0::2] = e
        out[1::2] = o
        return out

    return tuple(merge(e, o) for e, o in zip(even, odd))


def analyze(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            cfg: CodecConfig) -> MCTFStream:
    """Forward MCTF of a (2k+1)-frame sequence; planes in [0,255] of any
    integer dtype, on the device the transform should run on."""
    return _analyze(y, u, v, cfg, _update_evens)


def _analyze(y, u, v, cfg: CodecConfig, update_evens) -> MCTFStream:
    low = (y.to(torch.int16), u.to(torch.int16), v.to(torch.int16))
    levels: List[LevelData] = []
    for lp in cfg.level_schedule():
        low, lev = _analyze_level(low, lp.block_size, lp.search_range, cfg,
                                  update_evens)
        levels.append(lev)
    return MCTFStream(low[0], low[1], low[2], tuple(levels))


def synthesize(stream: MCTFStream, cfg: CodecConfig,
               discard_TRLs: int = 0) -> Planes:
    """Inverse MCTF over the kept levels (``discard_TRLs`` finest levels
    dropped: ``stream.levels`` then holds only the coarser ones)."""
    return _synthesize(stream, cfg, discard_TRLs, _update_evens)


def _synthesize(stream: MCTFStream, cfg: CodecConfig, discard_TRLs: int,
                update_evens) -> Planes:
    low = tuple(p.to(torch.int16)
                for p in (stream.low_y, stream.low_u, stream.low_v))
    kept = cfg.level_schedule()[discard_TRLs:]
    for lp, lev in zip(reversed(kept), reversed(stream.levels)):
        lev = LevelData(lev.high_y.to(torch.int16),
                        lev.high_u.to(torch.int16),
                        lev.high_v.to(torch.int16),
                        lev.mv.to(torch.int32), lev.is_B)
        low = _synthesize_level(low, lev, lp.block_size, lp.search_range,
                                cfg, update_evens)
    return low

