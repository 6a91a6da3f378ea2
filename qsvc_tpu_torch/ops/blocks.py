"""Block-granular gather helpers for the plain versions of the motion
kernels (port of ``qsvc_tpu/ops/blocks.py``).

The JAX version gathers one padded-frame patch per block with a vmapped
``lax.dynamic_slice``; here the caller computes the per-block row and
column indices (clamped or masked as the padding would) and one advanced
index gathers every patch of every frame.
"""

from __future__ import annotations

import torch


def slice_start(start: torch.Tensor, size: int, win: int) -> torch.Tensor:
    """Where ``lax.dynamic_slice`` starts a ``win``-long slice of a
    ``size``-long axis: a negative start counts from the end of the axis,
    then the slice is clamped into it.  The plain versions place their
    block patches this way so that they equal the JAX package's gathers
    for every vector, including those reaching past the padding."""
    return torch.where(start < 0, start + size, start).clamp(0, size - win)


def gather_block_patches(img: torch.Tensor, rows: torch.Tensor,
                         cols: torch.Tensor) -> torch.Tensor:
    """Per-block patches ``out[p, i, j, ..., r, s] = img[p, ...,
    rows[p, i, j, r], cols[p, i, j, s]]``.

    ``img``: (P, H, W) or (P, C, H, W); ``rows``/``cols``: (P, By, Bx, ph)
    and (P, By, Bx, pw) in-range indices.  Returns (P, By, Bx, ph, pw) or
    (P, By, Bx, C, ph, pw)."""
    pidx = torch.arange(img.shape[0], device=img.device)[:, None, None,
                                                         None, None]
    r = rows[..., :, None]
    c = cols[..., None, :]
    if img.dim() == 3:
        return img[pidx, r, c]
    return img.permute(0, 2, 3, 1)[pidx, r, c].permute(0, 1, 2, 5, 3, 4)


def blocks_to_image(blocks: torch.Tensor) -> torch.Tensor:
    """(P, By, Bx, C, bs, bs) non-overlapping blocks -> (P, C, By*bs,
    Bx*bs)."""
    P, By, Bx, C, bs_y, bs_x = blocks.shape
    return blocks.permute(0, 3, 1, 4, 2, 5).reshape(P, C, By * bs_y,
                                                    Bx * bs_x)
