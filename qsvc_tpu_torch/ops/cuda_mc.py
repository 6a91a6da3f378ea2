"""Launch wrappers of K2 (MC predict), K3 (MC update, both directions)
and K4 (MC update, one direction) in ``csrc/mc.cu``, replacing
``qsvc_tpu/ops/pallas_mc.py::predict_pallas``, ``update2_pallas`` and
``update_pallas``.

CUDA tensors only; anything else raises.  The plain PyTorch versions are
``mctf/predict.py::predict_frames_plain`` and
``mctf/update.py::_update_field``,
which ``predict_frames_batch`` / ``update_fields_batch2`` /
``update_fields_batch`` use for CPU tensors.

The kernels run one CTA per (block, pair), so a launch takes at most
:data:`MAX_PAIRS` pairs, and the update kernels index a plane with 32-bit
integers, so its frame has at most :data:`MAX_PLANE` pixels; the wrappers
raise beyond either.  Block size and search range are not limited.
"""

from __future__ import annotations

import torch

from . import cuda_lib

#: pairs per launch: the kernels' grid is (By * Bx, P), and CUDA caps its
#: second dimension at 65535
MAX_PAIRS = 65535
#: pixels per frame of K3 and K4, which index a plane with int32
MAX_PLANE = 2**31 - 1


def _geometry(H: int, W: int, mv: torch.Tensor, block_size: int):
    By, Bx = mv.shape[-2], mv.shape[-1]
    if (By * block_size, Bx * block_size) != (H, W):
        raise ValueError(f"frame {(H, W)} is not the {By}x{Bx} grid of "
                         f"{block_size}-pixel blocks")
    return By, Bx


def _check_limits(P: int, H: int, W: int, plane_limit: bool) -> None:
    if P > MAX_PAIRS:
        raise ValueError(f"{P} pairs: a launch takes at most {MAX_PAIRS}")
    if plane_limit and H * W > MAX_PLANE:
        raise ValueError(f"{H}x{W} frame: the update kernels take at most "
                         f"{MAX_PLANE} pixels")


def predict(refs_prev: torch.Tensor, refs_next: torch.Tensor,
            mv: torch.Tensor, block_size: int, border: int) -> torch.Tensor:
    """Bidirectional block prediction: (P, C, H, W) int16 references,
    (P, 2, 2, By, Bx) int32 vectors -> (P, C, H, W) int16 clipped
    truncating averages.  ``border`` is the edge-replication depth of the
    plain version (4 * search_range)."""
    P, C, H, W = refs_prev.shape
    By, Bx = _geometry(H, W, mv, block_size)
    _check_limits(P, H, W, plane_limit=False)
    cuda_lib.check_tensor("refs_prev", refs_prev, torch.int16, (P, C, H, W))
    cuda_lib.check_tensor("refs_next", refs_next, torch.int16, (P, C, H, W))
    cuda_lib.check_tensor("mv", mv, torch.int32, (P, 2, 2, By, Bx))
    out = torch.empty_like(refs_prev)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load()
    with torch.cuda.device(mv.device):
        err = lib.qsvc_mc_predict(
            cuda_lib.ptr(refs_prev), cuda_lib.ptr(refs_next),
            cuda_lib.ptr(mv), cuda_lib.ptr(out), P, C, H, W, By, Bx,
            block_size, border, cuda_lib.stream_ptr(mv))
        cuda_lib.launched("mc_predict", err)
    return out


def update2(contrib: torch.Tensor, mv: torch.Tensor, block_size: int,
            search_range: int) -> torch.Tensor:
    """Accumulated MC update for both directions: (P, C, H, W) int16
    contributions, (P, 2, 2, By, Bx) int32 vectors -> (P, 2, C, H, W)
    int32 sums (direction 0 = PREV reference, 1 = NEXT)."""
    P, C, H, W = contrib.shape
    By, Bx = _geometry(H, W, mv, block_size)
    _check_limits(P, H, W, plane_limit=True)
    cuda_lib.check_tensor("contrib", contrib, torch.int16, (P, C, H, W))
    cuda_lib.check_tensor("mv", mv, torch.int32, (P, 2, 2, By, Bx))
    K = -(-int(search_range) // block_size)
    out = torch.empty((P, 2, C, H, W), dtype=torch.int32,
                      device=contrib.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load()
    with torch.cuda.device(mv.device):
        err = lib.qsvc_mc_update2(
            cuda_lib.ptr(contrib), cuda_lib.ptr(mv), cuda_lib.ptr(out),
            P, C, H, W, By, Bx, block_size, K, int(search_range),
            cuda_lib.stream_ptr(mv))
        cuda_lib.launched("mc_update2", err)
    return out


def update1(contrib: torch.Tensor, mv_y: torch.Tensor, mv_x: torch.Tensor,
            block_size: int, search_range: int) -> torch.Tensor:
    """Accumulated MC update for one direction: (P, C, H, W) int16
    contributions, (P, By, Bx) int32 vector planes -> (P, C, H, W) int32
    sums."""
    P, C, H, W = contrib.shape
    By, Bx = _geometry(H, W, mv_y, block_size)
    _check_limits(P, H, W, plane_limit=True)
    cuda_lib.check_tensor("contrib", contrib, torch.int16, (P, C, H, W))
    cuda_lib.check_tensor("mv_y", mv_y, torch.int32, (P, By, Bx))
    cuda_lib.check_tensor("mv_x", mv_x, torch.int32, (P, By, Bx))
    K = -(-int(search_range) // block_size)
    out = torch.empty((P, C, H, W), dtype=torch.int32, device=contrib.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load()
    with torch.cuda.device(mv_y.device):
        err = lib.qsvc_mc_update1(
            cuda_lib.ptr(contrib), cuda_lib.ptr(mv_y), cuda_lib.ptr(mv_x),
            cuda_lib.ptr(out), P, C, H, W, By, Bx, block_size, K,
            int(search_range), cuda_lib.stream_ptr(mv_y))
        cuda_lib.launched("mc_update1", err)
    return out
