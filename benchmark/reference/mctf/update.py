"""MCTF update lifting step (forward = update, inverse = un_update).

Frozen copy of ``qsvc_tpu_torch/mctf/update.py`` (``trunk/src/update.cpp`` with that
module's documented deviations): each B-frame residue is added back into
both motion-compensated reference frames scaled by ``update_factor``.
The contribution is quantized first, ``int16(floor(float32(res) *
factor))``, so encoder and decoder add and subtract the same integers;
colliding contributions accumulate exactly in int32 and clamp once;
contributions from outside the frame drop.

The accumulation is a gather: destination p of block i sums
``contrib[p - mv_b]`` over every block b within ``K = ceil(search_range
/ block_size)`` blocks of i whose vector maps p into b.  For CUDA
tensors kernel K3 (``csrc/mc.cu``) does both directions in one launch
(the sequential MCTF) and kernel K4 one direction (the sharded MCTF of
``parallel/``, which exchanges halos between the two directions);
:func:`_update_field` is their plain version for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import blocks
from .predict import upsample_chroma


def _contrib(residue_444: torch.Tensor, update_factor: float
             ) -> torch.Tensor:
    """Per-pixel contribution floor(residue * factor), int16."""
    return torch.floor(residue_444.to(torch.float32) * update_factor
                       ).to(torch.int16)


def _update_sums(contrib: torch.Tensor, mv_y: torch.Tensor,
                 mv_x: torch.Tensor, block_size: int, search_range: int
                 ) -> torch.Tensor:
    """Accumulated update of one direction from int16 contributions
    (P, C, H, W) and vectors (P, By, Bx); returns (P, C, H, W) int32.

    Reads follow the JAX version's ``search_range``-deep zero padding and
    its ``lax.dynamic_slice`` patch start."""
    P, C, H, W = contrib.shape
    By, Bx = mv_y.shape[-2], mv_y.shape[-1]
    bs = block_size
    dev = contrib.device
    K = -(-int(search_range) // bs)
    S = int(search_range)
    iota = torch.arange(bs, device=dev)
    ar_y = torch.arange(By, device=dev)
    ar_x = torch.arange(Bx, device=dev)
    out = torch.zeros((P, By, Bx, C, bs, bs), dtype=torch.int32, device=dev)
    for dy in range(-K, K + 1):
        for dx in range(-K, K + 1):
            byc = (ar_y + dy).clamp(0, By - 1)
            bxc = (ar_x + dx).clamp(0, Bx - 1)
            in_grid = (((ar_y + dy >= 0) & (ar_y + dy < By))[:, None]
                       & ((ar_x + dx >= 0) & (ar_x + dx < Bx))[None, :])
            mvy = mv_y[:, byc[:, None], bxc[None, :]]      # (P, By, Bx)
            mvx = mv_x[:, byc[:, None], bxc[None, :]]
            # patch of the zero-padded frame at base - mv_b (placed as
            # lax.dynamic_slice places it), in unpadded coordinates
            sy = blocks.slice_start(ar_y[:, None] * bs - mvy + S,
                                    H + 2 * S, bs) - S
            sx = blocks.slice_start(ar_x[None, :] * bs - mvx + S,
                                    W + 2 * S, bs) - S
            rows = sy[..., None] + iota                    # (P, By, Bx, bs)
            cols = sx[..., None] + iota
            patches = blocks.gather_block_rows(
                contrib, rows.clamp(0, H - 1), cols.clamp(0, W - 1))
            # dest pixel r receives contrib[r - mv_b] iff that lies in
            # source block b: r in [mv + d*bs, mv + d*bs + bs)
            lo_y = (mvy + dy * bs)[..., None]
            lo_x = (mvx + dx * bs)[..., None]
            rmask = (iota >= lo_y) & (iota < lo_y + bs) & (rows >= 0) \
                & (rows < H)
            cmask = (iota >= lo_x) & (iota < lo_x + bs) & (cols >= 0) \
                & (cols < W)
            m = (in_grid[None, :, :, None, None] & rmask[..., :, None]
                 & cmask[..., None, :])
            out += torch.where(m[:, :, :, None], patches, 0)
    return blocks.blocks_to_images(out)


def _update_field(residue_444: torch.Tensor, mv_dir_y: torch.Tensor,
                  mv_dir_x: torch.Tensor, block_size: int,
                  update_factor: float, search_range: int = 128
                  ) -> torch.Tensor:
    """Plain version of K4 and of each direction of K3: the accumulated
    integer update ``sum floor(residue * update_factor)`` at
    motion-compensated destinations.  ``residue_444``: (P, C, H, W) unbiased residue;
    ``mv_dir_*``: (P, By, Bx).  Returns (P, C, H, W) int32."""
    return _update_sums(_contrib(residue_444, update_factor), mv_dir_y,
                        mv_dir_x, block_size, search_range)


def update_fields_batch(res444: torch.Tensor, mv_y: torch.Tensor,
                        mv_x: torch.Tensor, block_size: int,
                        update_factor: float, search_range: int
                        ) -> torch.Tensor:
    """Accumulated update for one direction of a level's pairs, on any
    device.  ``res444``: (P, C, H, W); ``mv_y``/``mv_x``: (P, By, Bx).
    Returns (P, C, H, W) int32."""
    return _update_field(res444, mv_y, mv_x, block_size, update_factor,
                         search_range)


def update_fields_batch2(res444: torch.Tensor, mv: torch.Tensor,
                         block_size: int, update_factor: float,
                         search_range: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulated update for both directions of a level's pairs, on any
    device.  ``res444``: (P, C, H, W); ``mv``: (P, 2, 2, By, Bx).
    Returns ``(upd_prev, upd_next)``."""
    return tuple(_update_field(res444, mv[:, d, 0], mv[:, d, 1],
                               block_size, update_factor, search_range)
                 for d in range(2))


def apply_update(even_444: torch.Tensor, upd: torch.Tensor, sign: int
                 ) -> torch.Tensor:
    """clip(frame ± upd, 0, 255) in the frame's dtype."""
    return (even_444 + sign * upd).clamp(0, 255).to(even_444.dtype)


def residue_to_444(high: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                   is_B) -> torch.Tensor:
    """Biased high-band planes of one frame -> unbiased (3, H, W) residue
    at luma res; zero for an I frame (``is_B`` a 0-dim bool tensor or a
    bool; update gated to B, update.cpp:601-618)."""
    is_B = torch.as_tensor(is_B, device=high[0].device).reshape(1)
    return residues_to_444(tuple(p[None] for p in high), is_B)[0]


def residues_to_444(high: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                    is_B: torch.Tensor) -> torch.Tensor:
    """Biased high-band planes (P, ...) -> unbiased (P, 3, H, W) residues
    at luma res; zero for I frames (``jax.vmap`` of
    :func:`residue_to_444`)."""
    hy, hu, hv = high
    res = torch.stack([hy - 128, upsample_chroma(hu - 128),
                       upsample_chroma(hv - 128)], dim=1)
    return torch.where(is_B[:, None, None, None], res, torch.zeros_like(res))
