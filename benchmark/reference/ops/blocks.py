"""Block-granular gather helpers for the plain versions of the motion
kernels (frozen copy of ``qsvc_tpu_torch/ops/blocks.py``).

The JAX version gathers one padded-frame patch per block with a vmapped
``lax.dynamic_slice``.  :func:`gather_block_patches` and
:func:`blocks_to_image` keep its contract (one frame's start grid);
the plain versions of the kernels use the batched forms
:func:`gather_block_rows`, where the caller computes the per-block row
and column indices (clamped or masked as the padding would) and one
advanced index gathers every patch of every frame, and
:func:`blocks_to_images`.
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


def gather_block_patches(img: torch.Tensor, start_y: torch.Tensor,
                         start_x: torch.Tensor, ph: int, pw: int
                         ) -> torch.Tensor:
    """Per-block patches ``out[i, j] = img[..., sy[i,j]:+ph, sx[i,j]:+pw]``
    (the JAX function's contract).

    ``img``: (..., Hp, Wp); ``start_y``/``start_x``: (By, Bx) integers,
    assumed in range (pad the image first; a start out of range is placed
    as ``lax.dynamic_slice`` places it).  Returns (By, Bx, ..., ph, pw)."""
    Hp, Wp = img.shape[-2], img.shape[-1]
    dev = img.device
    rows = (slice_start(start_y.to(torch.int64), Hp, ph)[..., None]
            + torch.arange(ph, device=dev))
    cols = (slice_start(start_x.to(torch.int64), Wp, pw)[..., None]
            + torch.arange(pw, device=dev))
    out = img[..., rows[:, :, :, None], cols[:, :, None, :]]
    lead = img.dim() - 2                 # out: (..., By, Bx, ph, pw)
    return out.permute((lead, lead + 1) + tuple(range(lead))
                       + (lead + 2, lead + 3))


def gather_block_rows(img: torch.Tensor, rows: torch.Tensor,
                      cols: torch.Tensor) -> torch.Tensor:
    """Per-block patches of a batch of frames, from per-block indices:
    ``out[p, i, j, ..., r, s] = img[p, ..., rows[p, i, j, r], cols[p, i,
    j, s]]``.

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
    """(By, Bx, ..., bs, bs) non-overlapping blocks -> (..., By*bs,
    Bx*bs) (the JAX function's contract)."""
    By, Bx = blocks.shape[0], blocks.shape[1]
    bs_y, bs_x = blocks.shape[-2], blocks.shape[-1]
    lead = tuple(blocks.shape[2:-2])
    n = len(lead)
    perm = tuple(range(2, 2 + n)) + (0, 2 + n, 1, 3 + n)
    return blocks.permute(perm).reshape(lead + (By * bs_y, Bx * bs_x))


def blocks_to_images(blocks: torch.Tensor) -> torch.Tensor:
    """(P, By, Bx, C, bs, bs) non-overlapping blocks of a batch of frames
    -> (P, C, By*bs, Bx*bs) (``jax.vmap`` of :func:`blocks_to_image`)."""
    return blocks_to_image(blocks.movedim(0, 2))
