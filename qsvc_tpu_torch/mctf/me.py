"""Hierarchical bidirectional block-matching motion estimation.

Port of ``qsvc_tpu/mctf/me.py`` (``trunk/src/motion_estimate.cpp``
FAST_SEARCH path):

* a 5/3 LL pyramid of depth ``round(log2(search_range)) - 1`` over the
  predicted and both reference lumas;
* at each depth every block refines its (PREV, NEXT) vectors over the
  9-point spiral, probes applied anti-symmetrically (PREV +d, NEXT -d),
  later probes winning ties;
* between depths the field is duplicated 2x2 onto the finer block grid,
  doubled and clamped to ``±search_range``;
* with ``subpixel_accuracy`` a > 0, a steps on frames interpolated x2 per
  step (5/3 zero-high synthesis): the vectors double, clamp to
  ``±(search_range << a)`` and refine once more at ``block_size << s``
  (``motion_estimate.cpp:361-407``), so they come out in units of
  ``2^-a`` pixel; each step's interpolation of the evens and odds is an
  ``mctf.interp`` program span (``part`` ``me_up``, its ``step``).

The refinement runs in kernel K1 (``csrc/me_refine.cu``) for CUDA
tensors and in :func:`_refine_level`, its plain PyTorch version, for CPU
tensors.  Reads outside the active (ny, nx) region replicate its edge.
"""

from __future__ import annotations

import math

import torch

from ..ops import blocks, cuda_me, dwt2d

# spiral order: later probes win ties; (0,0) last (motion_estimate.cpp:124-174)
SPIRAL = ((-1, -1), (-1, 1), (1, -1), (1, 1),
          (-1, 0), (1, 0), (0, 1), (0, -1), (0, 0))


def _ceil_half(x: int, times: int) -> int:
    for _ in range(times):
        x = (x + 1) // 2
    return x


def _window_rows(base: torch.Tensor, n_active: int, n_blocks: int,
                 block_size: int, lo: int, win: int) -> torch.Tensor:
    """Active-region indices of (win)-long windows starting at padded
    offset ``base`` in a frame padded by ``lo`` below and enough above
    (``me.py::_padded_active``): the start is placed as
    ``lax.dynamic_slice`` places it (a negative start counts from the end
    of the padded axis, then the window is clamped into it) and the reads
    are clamped to the active region as the edge padding replicates it."""
    hi = lo + win + max(0, (n_blocks - 1) * block_size + win - n_active)
    start = blocks.slice_start(base, n_active + lo + hi, win) - lo
    iota = torch.arange(win, device=base.device)
    return (start[..., None] + iota).clamp(0, n_active - 1)


def _refine_level(preds: torch.Tensor, prevs: torch.Tensor,
                  nexts: torch.Tensor, mv: torch.Tensor,
                  block_size: int, border: int, ny: int, nx: int,
                  max_mv: int) -> torch.Tensor:
    """Plain version of K1: one ±1 spiral refinement of all blocks of all
    pairs (local_me_for_image, motion_estimate.cpp:196-225).

    ``preds``/``prevs``/``nexts``: (P, H', W') int16 lumas with active
    region (ny, nx); ``mv``: (P, 2, 2, By, Bx) int32.  Returns the updated
    mv."""
    P, _, _, By, Bx = mv.shape
    bs = block_size
    win = bs + 2 * border
    dev = mv.device
    base_y = (torch.arange(By, device=dev) * bs)[:, None]
    base_x = (torch.arange(Bx, device=dev) * bs)[None, :]

    def rows_cols(off_y, off_x, lo, w):
        return (_window_rows(base_y + off_y, ny, By, bs, lo, w),
                _window_rows(base_x + off_x, nx, Bx, bs, lo, w))

    zero = torch.zeros((P, By, Bx), dtype=torch.int64, device=dev)
    predw = blocks.gather_block_rows(preds, *rows_cols(zero, zero, border,
                                                       win))
    lo = border + 1 + max_mv
    patches_p = blocks.gather_block_rows(
        prevs, *rows_cols(mv[:, 0, 0] + max_mv, mv[:, 0, 1] + max_mv, lo,
                          win + 2))
    patches_n = blocks.gather_block_rows(
        nexts, *rows_cols(mv[:, 1, 0] + max_mv, mv[:, 1, 1] + max_mv, lo,
                          win + 2))

    big = torch.iinfo(torch.int32).max
    best_err_p = torch.full((P, By, Bx), big, dtype=torch.int32, device=dev)
    best_err_n = best_err_p.clone()
    best_d_p = torch.zeros((P, 2, By, Bx), dtype=torch.int32, device=dev)
    best_d_n = torch.zeros_like(best_d_p)
    for dy, dx in SPIRAL:
        # PREV probes at +d, NEXT at -d (motion_estimate.cpp:89-101)
        sl_p = patches_p[..., 1 + dy:1 + dy + win, 1 + dx:1 + dx + win]
        sl_n = patches_n[..., 1 - dy:1 - dy + win, 1 - dx:1 - dx + win]
        # the per-pixel |diff| is int16; the window sums widen to int32
        err_p = (predw - sl_p).abs().to(torch.int32).sum(dim=(-2, -1),
                                                         dtype=torch.int32)
        err_n = (predw - sl_n).abs().to(torch.int32).sum(dim=(-2, -1),
                                                         dtype=torch.int32)
        take_p = err_p <= best_err_p           # later probe wins ties
        take_n = err_n <= best_err_n
        best_err_p = torch.where(take_p, err_p, best_err_p)
        best_err_n = torch.where(take_n, err_n, best_err_n)
        d = torch.tensor([dy, dx], dtype=torch.int32, device=dev)[:, None,
                                                                  None]
        best_d_p = torch.where(take_p[:, None], d, best_d_p)
        best_d_n = torch.where(take_n[:, None], -d, best_d_n)
    return mv + torch.stack([best_d_p, best_d_n], dim=1)


def _upsample_mv(mv: torch.Tensor, by_c: int, bx_c: int,
                 by_f: int, bx_f: int) -> torch.Tensor:
    """Duplicate the coarse (by_c, bx_c) field 2x2 onto the finer grid
    (motion_estimate.cpp:314-317)."""
    coarse = mv[..., :by_c, :bx_c]
    up = coarse.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    out = mv.clone()
    out[..., :by_f, :bx_f] = up[..., :by_f, :bx_f]
    return out


def _refine_level_batch(preds: torch.Tensor, prevs: torch.Tensor,
                        nexts: torch.Tensor, mv: torch.Tensor,
                        block_size: int, border: int, ny: int, nx: int,
                        max_mv: int) -> torch.Tensor:
    """Spiral refinement of a whole level's pairs: kernel K1 for CUDA
    tensors, :func:`_refine_level` for CPU tensors."""
    if not mv.is_cuda:
        return _refine_level(preds, prevs, nexts, mv, block_size, border,
                             ny, nx, max_mv)
    return cuda_me.refine(preds.contiguous(), prevs.contiguous(),
                          nexts.contiguous(), mv, block_size, border, ny, nx,
                          max_mv)


def estimate_pair(pred: torch.Tensor, ref_prev: torch.Tensor,
                  ref_next: torch.Tensor, block_size: int,
                  search_range: int, border_size: int = 0,
                  subpixel_accuracy: int = 0) -> torch.Tensor:
    """Motion field for one (even, odd, even) triple of (H, W) int16
    lumas: :func:`estimate_sequence` at one pair (kernel K1 for CUDA
    tensors).  Returns (2, 2, By, Bx) int32, [PREV|NEXT][y|x][by][bx],
    such that ``ref[y + mv_y, x + mv_x]`` predicts ``pred[y, x]``."""
    return estimate_sequence(torch.stack([ref_prev, ref_next]), pred[None],
                             block_size, search_range, border_size,
                             subpixel_accuracy)[0]


def estimate_sequence(evens: torch.Tensor, odds: torch.Tensor,
                      block_size: int, search_range: int,
                      border_size: int = 0, subpixel_accuracy: int = 0
                      ) -> torch.Tensor:
    """Motion fields for a whole temporal level.

    ``evens``: (P+1, H, W) int16 luma; ``odds``: (P, H, W).  Pair i uses
    (evens[i], odds[i], evens[i+1]).  Returns (P, 2, 2, By, Bx) int32."""
    P = odds.shape[0]
    H, W = odds.shape[-2], odds.shape[-1]
    By, Bx = H // block_size, W // block_size
    dwt_levels = max(int(round(math.log2(search_range))) - 1, 0)

    def ll_pyramid(stack):
        lls = [stack.contiguous()]
        for _ in range(dwt_levels):
            lls.append(dwt2d.downsample2(lls[-1]).contiguous())
        return lls

    lls_e = ll_pyramid(evens)
    lls_o = ll_pyramid(odds)

    mv = torch.zeros((P, 2, 2, By, Bx), dtype=torch.int32,
                     device=odds.device)

    # coarsest level first (motion_estimate.cpp:292-298)
    ny, nx = _ceil_half(H, dwt_levels), _ceil_half(W, dwt_levels)
    by_l, bx_l = _ceil_half(By, dwt_levels), _ceil_half(Bx, dwt_levels)
    mv[..., :by_l, :bx_l] = _refine_level_batch(
        lls_o[dwt_levels], lls_e[dwt_levels][:-1], lls_e[dwt_levels][1:],
        mv[..., :by_l, :bx_l], block_size, border_size, ny, nx,
        search_range)

    for l in range(dwt_levels - 1, -1, -1):
        ny, nx = _ceil_half(H, l), _ceil_half(W, l)
        by_f, bx_f = _ceil_half(By, l), _ceil_half(Bx, l)
        by_c, bx_c = _ceil_half(By, l + 1), _ceil_half(Bx, l + 1)
        mv = _upsample_mv(mv, by_c, bx_c, by_f, bx_f)
        mv = (mv * 2).clamp(-search_range, search_range)
        mv[..., :by_f, :bx_f] = _refine_level_batch(
            lls_o[l], lls_e[l][:-1], lls_e[l][1:], mv[..., :by_f, :bx_f],
            block_size, border_size, ny, nx, search_range)

    # sub-pixel steps: every step refines against PREV and NEXT at
    # cap = search_range << a (not << s); the ME pyramid is dead by now
    del lls_e, lls_o
    up_e, up_o = evens, odds
    cap = search_range << subpixel_accuracy
    for s in range(1, subpixel_accuracy + 1):
        # the refinements read every step's output; the first step reads
        # the frames (:func:`dwt2d.interp_span`); on the card one launch
        # of K6 writes both stacks
        with dwt2d.interp_span("me_up", [up_e, up_o], 1, reads=s == 1,
                               step=s):
            up_e, up_o = dwt2d.interpolate([up_e, up_o], 1)
        mv = (mv * 2).clamp(-cap, cap)
        mv = _refine_level_batch(up_o, up_e[:-1], up_e[1:], mv,
                                 block_size << s, border_size >> s, H << s,
                                 W << s, cap)
    return mv
