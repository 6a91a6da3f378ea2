"""MCTF predict lifting step (forward = decorrelate, inverse = correlate).

Port of ``qsvc_tpu/mctf/predict.py`` (``trunk/src/decorrelate.cpp``):

* chroma is interpolated to luma resolution (zero-high 5/3 synthesis)
  because vectors apply at luma precision to all components;
* the prediction of each pixel is the truncating average of the two
  motion-shifted references, clipped to [0,255] — kernel K2
  (``csrc/mc.cu``) for CUDA tensors, :func:`predict_frames_plain` for
  CPU tensors; reads beyond the frame replicate its edge;
* overlapped-block (OLA) prediction widens each block's window, filters
  it with a per-window 5/3 DWT and stitches the subbands: plain torch
  ops on every device, as in the JAX package (no kernel);
* sub-pixel prediction runs the block prediction on references
  interpolated x2 per accuracy step and brings it back down; each
  interpolation and decimation is an ``mctf.interp`` program span
  (``ops.dwt2d.interp_span``);
* the residue is ``clip(odd - prediction, -128, 127)`` stored +128 biased;
* the I/B decision compares first-order entropies:
  ``H(odd)*pixels <= H(residue)*pixels + H(motion)*blocks`` selects an
  I-frame, which stores the odd frame unchanged and zeroes its motion.

Each public function of the JAX module keeps its contract here: the
one-frame functions (:func:`predict_frame`, :func:`refs_to_444`,
:func:`decorrelate_from_pred`, :func:`correlate_from_pred`, the pair
steps) take one frame, and on CUDA tensors run the batched path's kernel
as a batch of one.  The MCTF uses their batched forms, which take a
leading axis P of frame pairs: :func:`predict_frames_plain`,
:func:`refs_to_444_batch`, :func:`decorrelate_from_preds`,
:func:`correlate_from_preds`, and :func:`predict_frames_subpixel_evens`,
which interpolates a level's evens once.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..ops import blocks, cuda_mc, dwt2d
from ..ops.entropy import histogram_entropy_rows
from ..ops.lifting import tdiv


class FramePlanes(NamedTuple):
    """One frame stack: luma (N, H, W), chroma u/v (N, H/2, W/2)."""
    y: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


def upsample_chroma(c: torch.Tensor) -> torch.Tensor:
    """Chroma to luma resolution (zero-high 5/3 synthesis,
    decorrelate.cpp:610-648)."""
    return dwt2d.upsample2(c)


def downsample_chroma(c: torch.Tensor) -> torch.Tensor:
    """Luma-res chroma back to 4:2:0 (one analysis level, LL kept,
    decorrelate.cpp:860-861)."""
    return dwt2d.downsample2(c)


#: window elements one OLA chunk gathers per reference, at most (a chunk
#: is whole block rows of one pair)
OLA_CHUNK = 1 << 27


def mv_to_pixel_map(mv: torch.Tensor, block_size: int, H: int, W: int
                    ) -> torch.Tensor:
    """Expand a block motion field (..., By, Bx) to per-pixel (..., H, W)."""
    m = mv.repeat_interleave(block_size, dim=-2).repeat_interleave(
        block_size, dim=-1)
    return m[..., :H, :W]


def _patch_index(origin: torch.Tensor, n: int, border: int, win: int,
                 lead: int) -> torch.Tensor:
    """Indices along an axis of ``n`` pixels of ``win``-long patches that
    start ``lead`` before each block's shifted origin (block base plus
    vector), as the JAX version reads them: from the axis padded by
    ``border`` replicated pixels, at the ``lax.dynamic_slice`` start."""
    start = blocks.slice_start(origin + border - lead, n + 2 * border,
                               win) - border
    iota = torch.arange(win, device=origin.device)
    return (start[..., None] + iota).clamp(0, n - 1)


def _block_patches(ref: torch.Tensor, mv_y: torch.Tensor,
                   mv_x: torch.Tensor, block_size: int, border: int,
                   win: int, lead: int = 0, row0: int = 0) -> torch.Tensor:
    """(P, By, Bx, C, win, win) patches of ``ref`` (P, C, H, W): block
    (row0 + i, j) read ``lead`` pixels before its origin shifted by its
    vector, edge-padded by ``border`` as the JAX gathers read it."""
    H, W = ref.shape[-2], ref.shape[-1]
    By, Bx = mv_y.shape[-2], mv_y.shape[-1]
    dev = ref.device
    base_y = ((torch.arange(By, device=dev) + row0) * block_size)[:, None]
    base_x = (torch.arange(Bx, device=dev) * block_size)[None, :]
    rows = _patch_index(base_y + mv_y, H, border, win, lead)
    cols = _patch_index(base_x + mv_x, W, border, win, lead)
    return blocks.gather_block_rows(ref, rows, cols)


def _mc_gather(ref: torch.Tensor, mv_y: torch.Tensor, mv_x: torch.Tensor,
               block_size: int, border: int) -> torch.Tensor:
    """Motion-compensated gather: out block (i,j) = the ``ref`` block
    shifted by that block's vector.  Reads follow the JAX version's
    ``border``-deep edge padding and its ``lax.dynamic_slice`` patch
    start.

    ``ref``: (P, C, H, W); ``mv_y``/``mv_x``: (P, By, Bx)."""
    return blocks.blocks_to_images(_block_patches(
        ref, mv_y, mv_x, block_size, border, block_size))


def predict_frame(ref_prev: torch.Tensor, ref_next: torch.Tensor,
                  mv: torch.Tensor, block_size: int, border: int
                  ) -> torch.Tensor:
    """Bidirectional prediction of one frame at luma resolution.

    ``ref_*``: (C, H, W) (chroma already upsampled; int16 on CUDA);
    ``mv``: (2 dirs, 2 comps, By, Bx).  Kernel K2 for CUDA tensors, as a
    batch of one; :func:`predict_frames_plain` for CPU tensors."""
    return _predict(ref_prev[None], ref_next[None], mv[None], block_size,
                    border)[0]


def predict_frames_plain(refs_prev: torch.Tensor, refs_next: torch.Tensor,
                         mv: torch.Tensor, block_size: int, border: int
                         ) -> torch.Tensor:
    """Plain version of K2: bidirectional prediction of a batch of pairs
    at luma resolution, edge-padded by ``border``.

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
    tensors, :func:`predict_frames_plain` for CPU tensors; with
    ``block_overlaping`` :func:`_predict_frames_ola` on either.
    ``refs_*``: (P, C, H, W) int16; ``mv``: (P, 2, 2, By, Bx) int32."""
    if block_overlaping > 0:
        return _predict_frames_ola(refs_prev, refs_next, mv, block_size,
                                   search_range, block_overlaping)
    return _predict(refs_prev, refs_next, mv, block_size, 4 * search_range)


def _predict(refs_prev: torch.Tensor, refs_next: torch.Tensor,
             mv: torch.Tensor, block_size: int, border: int
             ) -> torch.Tensor:
    """Block prediction of a batch of pairs edge-padded by ``border``:
    kernel K2 for CUDA tensors, :func:`predict_frames_plain` for CPU
    tensors."""
    if not mv.is_cuda:
        return predict_frames_plain(refs_prev, refs_next, mv, block_size,
                                    border)
    return cuda_mc.predict(refs_prev.contiguous(), refs_next.contiguous(),
                           mv.contiguous(), block_size, border)


def _predict_frames_ola(refs_prev: torch.Tensor, refs_next: torch.Tensor,
                        mv: torch.Tensor, block_size: int,
                        search_range: int, block_overlaping: int
                        ) -> torch.Tensor:
    """Overlapped-block (OLA) bidirectional prediction
    (decorrelate.cpp:69-189): each block's window is widened by ``d =
    block_overlaping`` pixels per side, the truncating average of its two
    references analysed by a packed 5/3 DWT of ``log2 d`` levels (in
    int16, as the JAX version's lifting runs), each subband cropped back
    to the block's own coefficients, stitched into a frame-wide packed
    pyramid and synthesized, then clipped to [0, 255].

    Windows are independent, so they are gathered and analysed in chunks
    of whole block rows of one pair (at most :data:`OLA_CHUNK` elements
    per reference): the sub-pixel windows are large.  ``refs``:
    (P, C, H, W) int16; ``mv``: (P, 2, 2, By, Bx).  Returns (P, C, H, W).
    """
    d = block_overlaping
    levels = int(round(math.log2(d)))
    bs = block_size
    P, C, H, W = refs_prev.shape
    By, Bx = H // bs, W // bs
    border = 4 * search_range + d
    win = bs + 2 * d
    step = max(1, OLA_CHUNK // (Bx * C * win * win))
    out = torch.empty_like(refs_prev)
    for p in range(P):
        canvas = refs_prev.new_zeros((C, H, W))
        for i0 in range(0, By, step):
            n = min(step, By - i0)

            def windows(ref, v):             # v: (P, 2, By, Bx) of a direction
                v = v[p:p + 1, :, i0:i0 + n]
                return _block_patches(ref[p:p + 1], v[:, 0], v[:, 1], bs,
                                      border, win, d, i0)
            wp = windows(refs_prev, mv[:, 0])
            wn = windows(refs_next, mv[:, 1])
            avg = tdiv(wp + wn, 2)                # decorrelate.cpp:106
            del wp, wn
            packed = dwt2d.analyze(avg, levels)[0]   # (n, Bx, C, w, w)
            del avg

            def stitch(sub, y, x, b):
                # (n, Bx, C, b, b) -> canvas rows of block rows i0..i0+n
                canvas[:, y + i0 * b:y + (i0 + n) * b, x:x + Bx * b] = (
                    sub.permute(2, 0, 3, 1, 4).reshape(C, n * b, Bx * b))
            for l in range(1, levels + 1):
                b, off, hoff = bs >> l, d >> l, (bs + 3 * d) >> l
                Hl, Wl = H >> l, W >> l
                stitch(packed[..., off:off + b, hoff:hoff + b], 0, Wl, b)
                stitch(packed[..., hoff:hoff + b, off:off + b], Hl, 0, b)
                stitch(packed[..., hoff:hoff + b, hoff:hoff + b], Hl, Wl, b)
            b, off = bs >> levels, d >> levels
            stitch(packed[..., off:off + b, off:off + b], 0, 0, b)
        out[p] = dwt2d.synthesize(canvas, levels).clamp(0, 255)
    return out


def predict_frames_subpixel(refs_prev: torch.Tensor,
                            refs_next: torch.Tensor, mv: torch.Tensor,
                            block_size: int, search_range: int,
                            subpixel_accuracy: int,
                            block_overlaping: int = 0) -> torch.Tensor:
    """Bidirectional prediction of a level's pairs with sub-pixel motion
    (decorrelate.cpp:656-686, 828-861): the 4:4:4 references are
    interpolated x2 per accuracy step, the block prediction runs at
    ``block_size << a`` with the vectors as they are (in units of 2^-a
    pixel), then ``a`` analysis levels keeping LL bring it back.

    ``refs_*``: (P, C, H, W) int16; ``mv``: (P, 2, 2, By, Bx).  Returns
    (P, C, H, W)."""
    a = subpixel_accuracy
    up_prev, up_next = _interpolate(refs_prev, a), _interpolate(refs_next, a)
    pred = predict_frames_batch(up_prev, up_next, mv, block_size << a,
                                search_range << a, block_overlaping << a)
    del up_prev, up_next
    return _decimate(pred, a)


def predict_frames_subpixel_evens(evens444: torch.Tensor, mv: torch.Tensor,
                                  block_size: int, search_range: int,
                                  subpixel_accuracy: int,
                                  block_overlaping: int = 0
                                  ) -> torch.Tensor:
    """:func:`predict_frames_subpixel` of a level's pairs from its evens:
    ``evens444`` (P+1, C, H, W) int16, pair i predicts from evens i and
    i+1.  The evens are interpolated once and sliced (the same values as
    interpolating the PREV and NEXT stacks apart, at half the memory)."""
    a = subpixel_accuracy
    up = _interpolate(evens444, a)
    pred = predict_frames_batch(up[:-1], up[1:], mv, block_size << a,
                                search_range << a, block_overlaping << a)
    del up
    return _decimate(pred, a)


def _interpolate(frames: torch.Tensor, a: int) -> torch.Tensor:
    """``a`` steps of x2 interpolation (zero-high 5/3 synthesis; on the
    card one launch of K6)."""
    with dwt2d.interp_span("pred_up", [frames], a):
        return dwt2d.interpolate([frames], a)[0]


def _decimate(pred: torch.Tensor, a: int) -> torch.Tensor:
    """``a`` analysis levels keeping LL: back to base resolution (on the
    card one launch of K7)."""
    with dwt2d.interp_span("pred_down", [pred], a, up=False):
        return dwt2d.decimate(pred, a)


def refs_to_444(frame: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                ) -> torch.Tensor:
    """(y, u, v) planes of one frame at native 4:2:0 -> (3, H, W) stack at
    luma resolution."""
    y, u, v = frame
    return torch.stack([y, upsample_chroma(u), upsample_chroma(v)])


def refs_to_444_batch(frames: Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]) -> torch.Tensor:
    """(y, u, v) stacks (N, H, W), (N, H/2, W/2) -> (N, 3, H, W) at luma
    resolution (``jax.vmap`` of :func:`refs_to_444`)."""
    y, u, v = frames
    return torch.stack([y, upsample_chroma(u), upsample_chroma(v)], dim=1)


class PredictResult(NamedTuple):
    """The predict step's result: of one frame (``is_B`` 0-dim) from the
    one-frame functions, of P frames (leading axis P) from the batched
    ones."""
    high_y: torch.Tensor      # biased residue or raw I-frame luma (H, W)
    high_u: torch.Tensor      # (H/2, W/2)
    high_v: torch.Tensor
    mv_out: torch.Tensor      # motion field, zeroed for I frames
    is_B: torch.Tensor        # bool frame type


def decorrelate_from_pred(odd: Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor],
                          pred: torch.Tensor, mv: torch.Tensor,
                          always_B: bool = False) -> PredictResult:
    """Residue formation + I/B decision of one odd frame given its 4:4:4
    prediction ``pred`` (3, H, W) and its vectors (2, 2, By, Bx)."""
    res = decorrelate_from_preds(tuple(p[None] for p in odd), pred[None],
                                 mv[None], always_B)
    return PredictResult(*(t[0] for t in res))


def decorrelate_from_preds(odd: Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor],
                           pred: torch.Tensor, mv: torch.Tensor,
                           always_B: bool = False) -> PredictResult:
    """Residue formation + I/B decision of P odd frames given their 4:4:4
    predictions ``pred`` (P, 3, H, W) and vectors (P, 2, 2, By, Bx)
    (``jax.vmap`` of :func:`decorrelate_from_pred`)."""
    oy, ou, ov = odd
    P, H, W = oy.shape
    By, Bx = mv.shape[-2], mv.shape[-1]
    pred_u = downsample_chroma(pred[:, 1])
    pred_v = downsample_chroma(pred[:, 2])

    res_y = (oy - pred[:, 0]).clamp(-128, 127)
    res_u = (ou - pred_u).clamp(-128, 127)
    res_v = (ov - pred_v).clamp(-128, 127)

    # I/B decision on luma + motion entropy (decorrelate.cpp:934-979)
    predicted_entropy = histogram_entropy_rows(oy.clamp(0, 255))
    residue_entropy = histogram_entropy_rows(res_y + 128)
    motion_entropy = histogram_entropy_rows(mv.reshape(P, -1) + 128,
                                            bins=257)
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


def decorrelate_pair(odd: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                     ref_prev_444: torch.Tensor, ref_next_444: torch.Tensor,
                     mv: torch.Tensor, block_size: int, search_range: int,
                     block_overlaping: int = 0, always_B: bool = False
                     ) -> PredictResult:
    """Forward predict step for one odd frame (decorrelate.cpp ANALYZE
    path): (H, W) luma and (H/2, W/2) chroma int16 planes, (3, H, W)
    4:4:4 references, (2, 2, By, Bx) int32 vectors.  The prediction reads
    the references edge-padded by ``4*search_range + block_overlaping``
    (:func:`predict_frame`).  Returns the :class:`PredictResult` of the
    one frame (``is_B`` a 0-dimensional bool tensor)."""
    pred = predict_frame(ref_prev_444, ref_next_444, mv, block_size,
                         4 * search_range + block_overlaping)
    return decorrelate_from_pred(odd, pred, mv, always_B)


def correlate_pair(high: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                   ref_prev_444: torch.Tensor, ref_next_444: torch.Tensor,
                   mv: torch.Tensor, is_B: torch.Tensor, block_size: int,
                   search_range: int, block_overlaping: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse predict step: reconstruct one odd frame
    (decorrelate.cpp:1036-1061 SYNTHESIZE path) from its high planes,
    the same prediction as :func:`decorrelate_pair` and its ``is_B``."""
    pred = predict_frame(ref_prev_444, ref_next_444, mv, block_size,
                         4 * search_range + block_overlaping)
    return correlate_from_pred(high, pred, is_B)


def correlate_from_pred(high: Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor],
                        pred: torch.Tensor, is_B
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse predict step of one odd frame from its high planes, its
    4:4:4 prediction (3, H, W) and its frame type ``is_B`` (a 0-dim bool
    tensor or a bool) (decorrelate.cpp:1036-1061)."""
    is_B = torch.as_tensor(is_B, device=pred.device).reshape(1)
    out = correlate_from_preds(tuple(p[None] for p in high), pred[None],
                               is_B)
    return tuple(p[0] for p in out)


def correlate_from_preds(high: Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor],
                         pred: torch.Tensor, is_B: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Inverse predict step of P odd frames: high planes (P, ...),
    predictions (P, 3, H, W), frame types (P,) (``jax.vmap`` of
    :func:`correlate_from_pred`)."""
    hy, hu, hv = high
    pred_u = downsample_chroma(pred[:, 1])
    pred_v = downsample_chroma(pred[:, 2])
    b3 = is_B[:, None, None]
    oy = ((hy - 128) + pred[:, 0]).clamp(0, 255)
    ou = ((hu - 128) + pred_u).clamp(0, 255)
    ov = ((hv - 128) + pred_v).clamp(0, 255)
    return (torch.where(b3, oy, hy), torch.where(b3, ou, hu),
            torch.where(b3, ov, hv))
