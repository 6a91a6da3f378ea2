"""Launch wrapper of K1, the spiral-SAD refinement kernel
(``csrc/me_refine.cu``, replacing ``qsvc_tpu/ops/pallas_me.py::
refine_pallas``).

Takes CUDA tensors only and raises on anything else; the plain PyTorch
version is ``mctf/me.py::_refine_level``, which ``me._refine_level_batch``
uses for CPU tensors.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def refine(preds: torch.Tensor, prevs: torch.Tensor, nexts: torch.Tensor,
           mv: torch.Tensor, block_size: int, border: int, ny: int, nx: int,
           max_mv: int) -> torch.Tensor:
    """One spiral refinement of every block of every pair.

    ``preds``/``prevs``/``nexts``: (P, H', W') int16 with active region
    (ny, nx); ``mv``: (P, 2, 2, By, Bx) int32.  Returns the (P, 4, By, Bx)
    int32 winning deltas ``[dy_prev, dx_prev, dy_next, dx_next]``."""
    if border != 0:
        raise NotImplementedError("K1 supports border_size == 0 only")
    P, H, W = preds.shape
    By, Bx = mv.shape[-2], mv.shape[-1]
    for name, t in (("preds", preds), ("prevs", prevs), ("nexts", nexts)):
        cuda_lib.check_tensor(name, t, torch.int16, (P, H, W))
    cuda_lib.check_tensor("mv", mv, torch.int32, (P, 2, 2, By, Bx))
    if not (0 < ny <= H and 0 < nx <= W):
        raise ValueError(f"active region {(ny, nx)} outside {(H, W)}")
    out = torch.empty((P, 4, By, Bx), dtype=torch.int32, device=mv.device)
    if P * By * Bx == 0:
        return out
    lib = cuda_lib.load()
    with torch.cuda.device(mv.device):
        err = lib.qsvc_me_refine(
            cuda_lib.ptr(preds), cuda_lib.ptr(prevs), cuda_lib.ptr(nexts),
            cuda_lib.ptr(mv), cuda_lib.ptr(out), P, H, W, ny, nx, By, Bx,
            block_size, max_mv, cuda_lib.stream_ptr(mv))
        cuda_lib.launched("me_refine", err)
    return out
