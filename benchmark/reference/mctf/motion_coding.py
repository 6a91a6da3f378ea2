"""Motion-vector field decorrelation across temporal levels.

Frozen copy of ``qsvc_tpu_torch/mctf/motion_coding.py`` (reference
``motion_compress.py:146-180``): each field at level ``t`` is predicted by
half the co-located field of level ``t+1`` (pair ``i`` maps to coarse
pair ``i // 2``, C truncating division), and at the coarsest level
``NEXT -= PREV``.  Coarser grids are expanded to finer ones by
nearest-neighbour duplication.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops.lifting import tdiv


def _expand_to(coarse: torch.Tensor, By: int, Bx: int) -> torch.Tensor:
    """NN-duplicate a (..., by, bx) field onto a (..., By, Bx) grid."""
    by, bx = coarse.shape[-2], coarse.shape[-1]
    if (by, bx) == (By, Bx):
        return coarse
    ry, rx = -(-By // by), -(-Bx // bx)
    up = coarse.repeat_interleave(ry, dim=-2).repeat_interleave(rx, dim=-1)
    return up[..., :By, :Bx]


def _coarse_ref(coarse: torch.Tensor, fine_shape) -> torch.Tensor:
    P, _, _, By, Bx = fine_shape
    idx = torch.arange(P, device=coarse.device) // 2
    return _expand_to(coarse[idx], By, Bx)


def decorrelate(fields: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Forward MV decorrelation.  ``fields[t]``: (P_t, 2, 2, By_t, Bx_t),
    finest level first; returns residue fields of the same shapes."""
    L = len(fields)
    out: List[torch.Tensor] = []
    for t in range(L - 1):
        fine = fields[t]
        out.append(fine - tdiv(_coarse_ref(fields[t + 1], fine.shape), 2))
    res = fields[L - 1].clone()
    res[:, 1] -= fields[L - 1][:, 0]        # NEXT -= PREV at the coarsest
    out.append(res)
    return out


def correlate(residues: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Inverse of :func:`decorrelate` (coarsest reconstructed first)."""
    L = len(residues)
    fields: List[torch.Tensor] = [None] * L
    coarsest = residues[L - 1].clone()
    coarsest[:, 1] += residues[L - 1][:, 0]
    fields[L - 1] = coarsest
    for t in range(L - 2, -1, -1):
        res = residues[t]
        fields[t] = res + tdiv(_coarse_ref(fields[t + 1], res.shape), 2)
    return fields

