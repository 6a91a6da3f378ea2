"""Launch wrapper of K1, the spiral-SAD refinement kernel
(``csrc/me_refine.cu``, replacing ``qsvc_tpu/ops/pallas_me.py::
refine_pallas``).

Takes CUDA tensors only and raises on anything else; the plain PyTorch
version is ``mctf/me.py::_refine_level``, which ``me._refine_level_batch``
uses for CPU tensors.

The kernel runs one CTA per (block, pair), or a cluster of ``split`` CTAs
per block that share the rows of its window; its grid is (Bx * split, By,
P), so a launch takes at most :data:`MAX_PAIRS` pairs and block rows.  A
CTA walks its rows of the ``block_size + 2 * border`` window in pieces
(:func:`layout`), so any block size and border fit its shared memory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib

#: CTAs of one thread-block cluster (the portable cluster size)
MAX_SPLIT = 8
#: pairs and block rows per launch: CUDA caps a grid's second and third
#: dimensions at 65535
MAX_PAIRS = 65535
#: threads of a CTA at most, and the widest column tile of a piece
THREADS = 256
#: rows of a thread's run in a piece
RUN = 32


class Layout(NamedTuple):
    """How a CTA walks its rows of a window (``csrc/me_refine.cu::layout``
    computes the same): pieces of ``tw`` columns by ``pr`` rows, summed by
    ``threads`` threads, each owning one column and up to :data:`RUN`
    rows of a piece."""
    win: int
    tw: int
    pr: int
    threads: int


def layout(block_size: int, border: int, split: int) -> Layout:
    win = block_size + 2 * border
    tiles = -(-win // THREADS)
    tw = -(-win // tiles)
    rows = -(-win // split)
    want = tw * -(-rows // RUN)
    threads = min(THREADS, -(-want // 32) * 32)
    return Layout(win, tw, min(rows, threads // tw * RUN), threads)


def smem_bytes(block_size: int, split: int, border: int = 0) -> int:
    """Shared memory of a CTA: one piece of the predicted window and of
    both reference windows (2 more rows and columns) as int16, each row
    staged from a 16-byte aligned column (7 more values, rounded up to
    8).  Bounded whatever the block size and border: at most 55,424
    bytes, well under the 227 KB a CTA may take, so memory never calls
    for a split."""
    lay = layout(block_size, border, split)

    def staged_row(width):
        return -(-(width + 7) // 8) * 8
    return 2 * (lay.pr * staged_row(lay.tw)
                + 2 * (lay.pr + 2) * staged_row(lay.tw + 2))


def auto_split(n_blocks: int, block_size: int, sms: int) -> int:
    """CTAs per block: a cluster of 8 where even 8 CTAs per block leave
    SMs idle (the flagship's 4- and 12-block calls, where it saves about
    1 us of a 6 us call on the H100; at 24 and 40 blocks, 5 and 3 CTAs per
    block gained nothing), else one."""
    top = min(MAX_SPLIT, block_size)
    return top if n_blocks * top <= sms else 1


def refine(preds: torch.Tensor, prevs: torch.Tensor, nexts: torch.Tensor,
           mv: torch.Tensor, block_size: int, border: int, ny: int, nx: int,
           max_mv: int, split: int | None = None) -> torch.Tensor:
    """One spiral refinement of every block of every pair.

    ``preds``/``prevs``/``nexts``: contiguous (P, H', W') int16 with
    active region (ny, nx); ``mv``: (P, 2, 2, By, Bx) int32, any strides
    (a slice of a larger field is read in place).  Each block is matched
    over its window of ``block_size + 2 * border`` pixels.  Returns the
    refined vectors, ``mv`` plus the winning ±1 deltas, as a new
    contiguous (P, 2, 2, By, Bx) int32 tensor.  ``split``: CTAs that
    share each window's rows (1 to 8; default: :func:`auto_split`)."""
    if block_size < 1 or border < 0:
        raise ValueError(f"block size {block_size}, border {border}: K1 "
                         f"takes blocks of 1 pixel or more, borders >= 0")
    if split is not None and not 1 <= split <= min(MAX_SPLIT, block_size):
        raise ValueError(f"split {split}: K1 takes 1 to "
                         f"{min(MAX_SPLIT, block_size)} CTAs per block")
    P, H, W = preds.shape
    By, Bx = mv.shape[-2], mv.shape[-1]
    if max(P, By) > MAX_PAIRS:
        raise ValueError(f"{P} pairs of {By} block rows: a launch takes at "
                         f"most {MAX_PAIRS} pairs and block rows")
    for name, t in (("preds", preds), ("prevs", prevs), ("nexts", nexts)):
        cuda_lib.check_tensor(name, t, torch.int16, (P, H, W))
    cuda_lib.check_tensor("mv", mv, torch.int32, (P, 2, 2, By, Bx),
                          contiguous=False)
    if not (0 < ny <= H and 0 < nx <= W):
        raise ValueError(f"active region {(ny, nx)} outside {(H, W)}")
    if split is None:
        sms = torch.cuda.get_device_properties(mv.device).multi_processor_count
        split = auto_split(P * By * Bx, block_size, sms)
    out = torch.empty((P, 2, 2, By, Bx), dtype=torch.int32, device=mv.device)
    if P * By * Bx == 0:
        return out
    lib = cuda_lib.load()
    with torch.cuda.device(mv.device):
        err = lib.qsvc_me_refine(
            cuda_lib.ptr(preds), cuda_lib.ptr(prevs), cuda_lib.ptr(nexts),
            cuda_lib.ptr(mv), *mv.stride(), cuda_lib.ptr(out), P, H, W, ny,
            nx, By, Bx, block_size, border, max_mv, split,
            cuda_lib.stream_ptr(mv))
        cuda_lib.launched("me_refine", err)
    return out
