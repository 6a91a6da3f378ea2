"""The reference encode: frames in, stream bytes out.

The steps and their order are those of the program's ``api.compress``
(``compress_dispatch``, ``_dispatch_stream``, ``compress_finish``): the
MCTF analysis of the whole sequence, one texture stack for the luma of
every temporal subband and one for the chroma, each truncated at its
subband's slope threshold, the motion fields decorrelated and coded
losslessly, then the container.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .codec import container, texture
from .config import CodecConfig
from .mctf import motion_coding, transform


def operating_delta(cfg: CodecConfig) -> float:
    """The 9/7 base quantization step tied to the operating point."""
    t = texture.slope_to_threshold(float(cfg.quantization_texture))
    return float(np.clip(math.sqrt(t) / 8.0, 0.125, 8.0))


class Truth(NamedTuple):
    """What a stream's texture codes: per texture frame and component, in
    stream order, its quantized code-blocks (nb, cb, cb), each one's
    distortion weight (nb,) as the encoder's R-D weighs them, and the
    slope threshold its passes were truncated at (weighted squared error
    per byte)."""
    tiles: List[torch.Tensor]
    weights: List[torch.Tensor]
    thresholds: List[float]


def encode(y: np.ndarray, u: np.ndarray, v: np.ndarray, cfg: CodecConfig,
           device, dtype=torch.float32, truth: bool = False):
    """The lossy (9/7) stream of the uint8 planes ``y`` (n, H, W), ``u``
    and ``v`` (n, H/2, W/2), n = k * GOP size + 1 frames on the coded
    grid, computed on ``device``; ``dtype`` is the 9/7 transform's float
    type (float32 as configured; lower for the control).  With ``truth``,
    (stream, :class:`Truth`)."""
    n, H, W = y.shape
    S = cfg.gop_size
    gops = max(1, -(-(n - 1) // S))
    cfg = cfg.replace(pixels_in_x=W, pixels_in_y=H, GOPs=gops)
    if cfg.pictures != n or H % cfg.auto_block_size or W % cfg.auto_block_size:
        raise ValueError(f"{n} frames of {H}x{W} are not on the coded grid "
                         f"of this configuration")
    cfg.validate()
    reversible = False
    delta = operating_delta(cfg)
    up = [torch.from_numpy(np.ascontiguousarray(p, np.uint8)).to(device)
          for p in (y, u, v)]
    stream = transform.analyze(*up, cfg)
    del up

    slopes = cfg.slopes()

    def thr(row: int) -> float:
        return texture.slope_to_threshold(slopes[row][0])

    luma = [stream.low_y]
    chroma = [stream.low_u, stream.low_v]
    luma_thr = [np.full(stream.low_y.shape[0], thr(0))]
    chroma_thr = [np.full(2 * stream.low_u.shape[0], thr(0))]
    for t, lev in enumerate(stream.levels, start=1):
        mt = thr(cfg.TRLs - t)
        luma.append(lev.high_y)
        chroma += [lev.high_u, lev.high_v]
        luma_thr.append(np.full(lev.high_y.shape[0], mt))
        chroma_thr.append(np.full(2 * lev.high_u.shape[0], mt))
    srl = cfg.SRLs - 1
    cb = cfg.codeblock_size
    enc_l, tiles_l, w_l = texture.encode_planes(
        torch.cat(luma), srl, reversible, delta, cb,
        np.concatenate(luma_thr), dtype)
    enc_c, tiles_c, w_c = texture.encode_planes(
        torch.cat(chroma), srl, reversible, delta, cb,
        np.concatenate(chroma_thr), dtype)
    order: List[tuple] = []                 # (stack, plane) in stream order
    residues = [r.cpu().numpy() for r in motion_coding.decorrelate(
        [lev.mv for lev in stream.levels])] if stream.levels else []

    def plane_set(lo_y, lo_c, count, row) -> List[Dict[str, texture.Frame]]:
        t = thr(row)
        out = []
        for i in range(count):
            fr = {"y": enc_l[lo_y + i], "u": enc_c[lo_c + i],
                  "v": enc_c[lo_c + count + i]}
            order.extend([(0, lo_y + i, t), (1, lo_c + i, t),
                          (1, lo_c + count + i, t)])
            if t > 0:
                fr = {c: f.truncate(t) for c, f in fr.items()}
            out.append(fr)
        return out

    n0 = stream.low_y.shape[0]
    low = plane_set(0, 0, n0, 0)
    levels = []
    oy, oc = n0, 2 * n0
    for t, lev in enumerate(stream.levels, start=1):
        p = lev.high_y.shape[0]
        high = plane_set(oy, oc, p, cfg.TRLs - t)
        oy += p
        oc += 2 * p
        motion = [container.encode_motion_field(f) for f in residues[t - 1]]
        ftypes = bytes(b"B"[0] if b else b"I"[0]
                       for b in lev.is_B.cpu().numpy())
        levels.append((high, motion, ftypes))
    data = container.to_bytes(cfg, reversible, delta, low, levels)
    if not truth:
        return data
    stacks = (tiles_l, tiles_c)
    weights = [torch.as_tensor(w, device=device) for w in (w_l, w_c)]
    return data, Truth([stacks[s][i] for s, i, _t in order],
                       [weights[s] for s, _i, _t in order],
                       [t for _s, _i, t in order])
