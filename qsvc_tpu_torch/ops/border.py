"""Frame border handling (edge replication) and block windowing.

Port of ``qsvc_tpu/ops/border.py``.  The reference allocates frames with
a margin and replicates the nearest pixel into it (``texture.cpp:34-113``
``alloc``/``fill_border``).  The port's motion kernels (K1, K2) and their
plain versions read with clamped indices instead and do not call these
helpers; they are the plain tensor forms of the same edge rule.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pad_edge(x: torch.Tensor, border: int) -> torch.Tensor:
    """Edge-replicating pad of the last two axes under any leading axes
    (``texture.cpp:55-113``; ``jnp.pad(mode="edge")``): a gather with
    clamped indices, which takes a tensor of any rank."""
    if border == 0:
        return x
    H, W = x.shape[-2], x.shape[-1]
    iy = (torch.arange(-border, H + border, device=x.device)
          .clamp(0, H - 1))
    ix = (torch.arange(-border, W + border, device=x.device)
          .clamp(0, W - 1))
    return x[..., iy[:, None], ix[None, :]]


def block_index_grids(blocks_y: int, blocks_x: int, win: int,
                      block_size: int, offset: int, *, device="cuda"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block pixel coordinate grids of a (win x win) window anchored at
    each block's top-left corner minus ``offset``.

    Returns (iy, ix) int64 of shape (blocks_y, blocks_x, win, win) on
    ``device``, in un-padded frame coordinates (may be negative or beyond
    the frame; add the pad border before gathering)."""
    by = torch.arange(blocks_y, device=device)[:, None, None, None] \
        * block_size
    bx = torch.arange(blocks_x, device=device)[None, :, None, None] \
        * block_size
    wy = torch.arange(win, device=device)[None, None, :, None] - offset
    wx = torch.arange(win, device=device)[None, None, None, :] - offset
    shape = (blocks_y, blocks_x, win, win)
    return (by + wy).expand(shape), (bx + wx).expand(shape)
