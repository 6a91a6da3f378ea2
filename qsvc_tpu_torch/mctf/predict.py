"""MCTF predict lifting step (forward = decorrelate, inverse = correlate).

Port of ``qsvc_tpu/mctf/predict.py`` (``trunk/src/decorrelate.cpp``),
without overlapped-block (OLA) and sub-pixel prediction:

* chroma is interpolated to luma resolution (zero-high 5/3 synthesis)
  because vectors apply at luma precision to all components;
* the prediction of each pixel is the truncating average of the two
  motion-shifted references, clipped to [0,255] — kernel K2
  (``csrc/mc.cu``) for CUDA tensors, :func:`predict_frame` for CPU
  tensors; reads beyond the frame replicate its edge;
* the residue is ``clip(odd - prediction, -128, 127)`` stored +128 biased;
* the I/B decision compares first-order entropies:
  ``H(odd)*pixels <= H(residue)*pixels + H(motion)*blocks`` selects an
  I-frame, which stores the odd frame unchanged and zeroes its motion.

Every function works on a batch of frame pairs (leading axis P).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import blocks, cuda_mc, dwt2d
from ..ops.entropy import histogram_entropy
from ..ops.lifting import tdiv


def upsample_chroma(c: torch.Tensor) -> torch.Tensor:
    """Chroma to luma resolution (zero-high 5/3 synthesis,
    decorrelate.cpp:610-648)."""
    return dwt2d.upsample2(c)


def downsample_chroma(c: torch.Tensor) -> torch.Tensor:
    """Luma-res chroma back to 4:2:0 (one analysis level, LL kept,
    decorrelate.cpp:860-861)."""
    return dwt2d.downsample2(c)


def _mc_gather(ref: torch.Tensor, mv_y: torch.Tensor, mv_x: torch.Tensor,
               block_size: int, border: int) -> torch.Tensor:
    """Motion-compensated gather: out block (i,j) = the ``ref`` block
    shifted by that block's vector.  Reads follow the JAX version's
    ``border``-deep edge padding and its ``lax.dynamic_slice`` patch
    start.

    ``ref``: (P, C, H, W); ``mv_y``/``mv_x``: (P, By, Bx)."""
    P, C, H, W = ref.shape
    By, Bx = mv_y.shape[-2], mv_y.shape[-1]
    bs = block_size
    dev = ref.device
    iota = torch.arange(bs, device=dev)

    def idx(base, v, n):
        start = blocks.slice_start(base + v + border, n + 2 * border,
                                   bs) - border
        return (start[..., None] + iota).clamp(0, n - 1)

    rows = idx((torch.arange(By, device=dev) * bs)[:, None], mv_y, H)
    cols = idx((torch.arange(Bx, device=dev) * bs)[None, :], mv_x, W)
    return blocks.blocks_to_image(blocks.gather_block_patches(ref, rows,
                                                              cols))


def predict_frame(refs_prev: torch.Tensor, refs_next: torch.Tensor,
                  mv: torch.Tensor, block_size: int, border: int
                  ) -> torch.Tensor:
    """Plain version of K2: bidirectional prediction at luma resolution.

    ``refs_*``: (P, C, H, W) (chroma already upsampled); ``mv``:
    (P, 2 dirs, 2 comps, By, Bx)."""
    g_prev = _mc_gather(refs_prev, mv[:, 0, 0], mv[:, 0, 1], block_size,
                        border)
    g_next = _mc_gather(refs_next, mv[:, 1, 0], mv[:, 1, 1], block_size,
                        border)
    return tdiv(g_prev + g_next, 2).clamp(0, 255)


def predict_frames_batch(refs_prev: torch.Tensor, refs_next: torch.Tensor,
                         mv: torch.Tensor, block_size: int,
                         search_range: int, block_overlaping: int = 0
                         ) -> torch.Tensor:
    """Bidirectional prediction of a level's pairs: kernel K2 for CUDA
    tensors, :func:`predict_frame` for CPU tensors.  ``refs_*``:
    (P, C, H, W) int16; ``mv``: (P, 2, 2, By, Bx) int32."""
    if block_overlaping > 0:
        raise NotImplementedError("overlapped-block prediction is not "
                                  "ported yet")
    border = 4 * search_range + block_overlaping
    if not mv.is_cuda:
        return predict_frame(refs_prev, refs_next, mv, block_size, border)
    return cuda_mc.predict(refs_prev.contiguous(), refs_next.contiguous(),
                           mv.contiguous(), block_size, border)


def refs_to_444(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    """(N,H,W) luma + (N,H/2,W/2) chroma -> (N, 3, H, W) at luma res."""
    return torch.stack([y, upsample_chroma(u), upsample_chroma(v)], dim=1)


class PredictResult(NamedTuple):
    high_y: torch.Tensor      # (P, H, W) biased residue or raw I-frame luma
    high_u: torch.Tensor      # (P, H/2, W/2)
    high_v: torch.Tensor
    mv_out: torch.Tensor      # motion fields, zeroed for I frames
    is_B: torch.Tensor        # (P,) bool


def decorrelate_from_pred(odd: Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor],
                          pred: torch.Tensor, mv: torch.Tensor,
                          always_B: bool = False) -> PredictResult:
    """Residue formation + I/B decision given the 4:4:4 predictions
    ``pred`` (P, 3, H, W) of the odd frames."""
    oy, ou, ov = odd
    P, H, W = oy.shape
    By, Bx = mv.shape[-2], mv.shape[-1]
    pred_u = downsample_chroma(pred[:, 1])
    pred_v = downsample_chroma(pred[:, 2])

    res_y = (oy - pred[:, 0]).clamp(-128, 127)
    res_u = (ou - pred_u).clamp(-128, 127)
    res_v = (ov - pred_v).clamp(-128, 127)

    # I/B decision on luma + motion entropy (decorrelate.cpp:934-979)
    predicted_entropy = histogram_entropy(oy.clamp(0, 255))
    residue_entropy = histogram_entropy(res_y + 128)
    motion_entropy = histogram_entropy(mv.reshape(P, -1) + 128, bins=257)
    predicted_size = (predicted_entropy * float(H * W)).to(torch.int32)
    residue_size = (residue_entropy * float(H * W)).to(torch.int32)
    motion_size = (motion_entropy * float(By * Bx)).to(torch.int32)
    if always_B:
        is_B = torch.ones(P, dtype=torch.bool, device=oy.device)
    else:
        is_B = predicted_size > residue_size + motion_size

    b3 = is_B[:, None, None]
    high_y = torch.where(b3, (res_y + 128).clamp(0, 255), oy)
    high_u = torch.where(b3, (res_u + 128).clamp(0, 255), ou)
    high_v = torch.where(b3, (res_v + 128).clamp(0, 255), ov)
    mv_out = torch.where(is_B[:, None, None, None, None], mv,
                         torch.zeros_like(mv))
    return PredictResult(high_y, high_u, high_v, mv_out, is_B)


def correlate_from_pred(high: Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor],
                        pred: torch.Tensor, is_B: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse predict step: reconstruct the odd frames
    (decorrelate.cpp:1036-1061)."""
    hy, hu, hv = high
    pred_u = downsample_chroma(pred[:, 1])
    pred_v = downsample_chroma(pred[:, 2])
    b3 = is_B[:, None, None]
    oy = ((hy - 128) + pred[:, 0]).clamp(0, 255)
    ou = ((hu - 128) + pred_u).clamp(0, 255)
    ov = ((hv - 128) + pred_v).clamp(0, 255)
    return (torch.where(b3, oy, hy), torch.where(b3, ou, hu),
            torch.where(b3, ov, hv))
