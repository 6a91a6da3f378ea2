"""Launch wrapper of K5, the bp coder's R-D simulation (``csrc/bp_slope.cu``),
which replaces no TPU kernel: the JAX package computes
``qsvc_tpu/codec/bp_device.py::bp_max_slope`` in plain jnp.

CUDA tensors only; anything else raises.  The plain PyTorch version is
``codec/bp_device.py::bp_max_slope_plain``, which ``bp_max_slope`` uses for
CPU tensors.

The kernel runs one CTA per code-block with one thread per row and one
64-bit mask per row and bit-plane, so it takes square blocks whose side is
a power of two up to :data:`MAX_CB`, int16 coefficients (at most 16
bit-planes) and the cleanup pass's stripes of :data:`STRIPE` rows; the
wrapper raises on anything else.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_lib

#: the largest code-block side: a row is one 64-bit mask
MAX_CB = 64
#: the cleanup pass's stripe height, the bp coder's
STRIPE = 4
#: blocks per launch: the grid's first dimension
MAX_BLOCKS = 2**31 - 1


def bp_slope(tiles: torch.Tensor, th: torch.Tensor, tw: torch.Tensor,
             stripe: int = STRIPE) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bp_max_slope`` on the card: (K, cb, cb) int16 tiles and (K,)
    int32 true tile heights and widths -> per block (smax, d0), float32
    (K,).  Launches on the current stream and does not synchronize."""
    if stripe != STRIPE:
        raise ValueError(f"stripe {stripe}: the kernel codes stripes of "
                         f"{STRIPE} rows")
    if tiles.dim() != 3 or tiles.shape[1] != tiles.shape[2]:
        raise ValueError(f"tiles: expected (K, cb, cb), got "
                         f"{tuple(tiles.shape)}")
    K, cb, _ = tiles.shape
    if not 1 <= cb <= MAX_CB or cb & (cb - 1):
        raise ValueError(f"code-block size {cb}: the kernel takes powers "
                         f"of two up to {MAX_CB}")
    if K > MAX_BLOCKS:
        raise ValueError(f"{K} blocks: a launch takes at most {MAX_BLOCKS}")
    if tuple(th.shape) != (K,) or tuple(tw.shape) != (K,):
        raise ValueError(f"th, tw: expected shape ({K},), got "
                         f"{tuple(th.shape)} and {tuple(tw.shape)}")
    cuda_lib.check_tensor("tiles", tiles, torch.int16, (K, cb, cb))
    cuda_lib.check_tensor("th", th, torch.int32, (K,))
    cuda_lib.check_tensor("tw", tw, torch.int32, (K,))
    smax = torch.empty(K, dtype=torch.float32, device=tiles.device)
    d0 = torch.empty(K, dtype=torch.float32, device=tiles.device)
    if K == 0:
        return smax, d0
    lib = cuda_lib.load()
    with torch.cuda.device(tiles.device):
        err = lib.qsvc_bp_slope(
            cuda_lib.ptr(tiles), cuda_lib.ptr(th), cuda_lib.ptr(tw),
            cuda_lib.ptr(smax), cuda_lib.ptr(d0), K, cb,
            cuda_lib.stream_ptr(tiles))
        cuda_lib.launched("bp_slope", err)
    return smax, d0
