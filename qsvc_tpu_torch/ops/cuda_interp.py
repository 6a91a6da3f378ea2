"""Launch wrappers of K6 and K7, the MCTF's 5/3 interpolation and
decimation (``csrc/interp.cu``), which replace no TPU kernel: the JAX
package computes ``qsvc_tpu/ops/dwt2d.py::upsample2`` and ``downsample2``
in plain jnp.

CUDA tensors only; anything else raises.  The plain PyTorch versions are
``ops/dwt2d.py``'s ``_interp_axis`` and ``_low_axis``, which
``dwt2d.interpolate`` and ``dwt2d.decimate`` compose for CPU tensors.

Each launch runs all of a region's x2 steps, at most :data:`MAX_STEPS`,
over int16 stacks ``(..., H, W)`` whose rows are contiguous (any other
stack is copied first).  The grid takes one plane per index of its
third dimension, so a launch takes at most :data:`MAX_PLANES` planes,
and the kernels index a plane with int32, so its largest level has at
most :data:`MAX_PLANE` samples; the wrappers raise beyond either.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import cuda_lib

#: x2 steps a launch takes (the configuration's sub-pixel accuracy is at
#: most 3)
MAX_STEPS = 3
#: planes a launch takes: CUDA caps the grid's last dimension at 65535
MAX_PLANES = 65535
#: samples of a plane's largest level, indexed with int32
MAX_PLANE = 2**31 - 1


def _check_shape(name: str, x: torch.Tensor, steps: int, up: bool) -> None:
    if not 1 <= steps <= MAX_STEPS:
        raise ValueError(f"{steps} steps: a launch takes 1 to {MAX_STEPS}")
    if x.dim() < 2 or x.shape[-2] < 1 or x.shape[-1] < 1:
        raise ValueError(f"{name}: expected (..., H, W), got "
                         f"{tuple(x.shape)}")
    H, W = x.shape[-2], x.shape[-1]
    if up:
        H, W = H << steps, W << steps
    if H * W > MAX_PLANE:
        raise ValueError(f"{name}: {H}x{W} planes: the kernels take at "
                         f"most {MAX_PLANE} samples")


def _planes(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``x`` as (N, H, W) planes with contiguous rows, and the samples
    between two planes (a view where it can be one)."""
    H, W = x.shape[-2], x.shape[-1]
    x3 = x.reshape(-1, H, W)
    if x3.stride(-1) != 1 or x3.stride(-2) != W:
        x3 = x3.contiguous()
    return x3, x3.stride(0)


def upsample(xs: Sequence[torch.Tensor], steps: int) -> List[torch.Tensor]:
    """``steps`` zero-high 5/3 syntheses (``dwt2d.upsample2``) of each of
    ``xs``, one or two int16 stacks (..., H, W) of one frame size, in one
    launch of K6 -> (..., H << steps, W << steps) each.  Launches on the
    current stream and does not synchronize."""
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"{len(xs)} stacks: a launch takes 1 or 2")
    for i, x in enumerate(xs):
        _check_shape(f"xs[{i}]", x, steps, up=True)
    H, W = xs[0].shape[-2], xs[0].shape[-1]
    for i, x in enumerate(xs):
        if (x.shape[-2], x.shape[-1]) != (H, W):
            raise ValueError(f"xs[{i}]: frames of {tuple(x.shape[-2:])}, "
                             f"not {(H, W)}")
    for i, x in enumerate(xs):
        cuda_lib.check_tensor(f"xs[{i}]", x, torch.int16, x.shape,
                              contiguous=False)
    planes = [_planes(x) for x in xs]
    outs = [torch.empty(x.shape[:-2] + (H << steps, W << steps),
                        dtype=torch.int16, device=x.device) for x in xs]
    counts = [p.shape[0] for p, _ in planes]
    if sum(counts) > MAX_PLANES:
        raise ValueError(f"{sum(counts)} planes: a launch takes at most "
                         f"{MAX_PLANES}")
    if sum(counts) == 0:
        return outs
    (p0, s0), (p1, s1) = planes[0], planes[-1]
    n1 = counts[1] if len(xs) == 2 else 0
    lib = cuda_lib.load()
    with torch.cuda.device(p0.device):
        err = lib.qsvc_interp_up(
            cuda_lib.ptr(p0), s0, counts[0], cuda_lib.ptr(outs[0]),
            cuda_lib.ptr(p1), s1, n1, cuda_lib.ptr(outs[-1]), H, W, steps,
            cuda_lib.stream_ptr(p0))
        cuda_lib.launched("interp_up", err)
    return outs


def downsample(x: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` 5/3 analysis levels keeping LL (``dwt2d.downsample2``)
    of an int16 stack (..., H, W), H and W multiples of 2^steps, in one
    launch of K7 -> (..., H >> steps, W >> steps).  Launches on the
    current stream and does not synchronize."""
    _check_shape("x", x, steps, up=False)
    H, W = x.shape[-2], x.shape[-1]
    if H % (1 << steps) or W % (1 << steps):
        raise ValueError(f"x: {H}x{W} frames do not halve {steps} times")
    cuda_lib.check_tensor("x", x, torch.int16, x.shape, contiguous=False)
    p, stride = _planes(x)
    out = torch.empty(x.shape[:-2] + (H >> steps, W >> steps),
                      dtype=torch.int16, device=x.device)
    if p.shape[0] > MAX_PLANES:
        raise ValueError(f"{p.shape[0]} planes: a launch takes at most "
                         f"{MAX_PLANES}")
    if p.shape[0] == 0:
        return out
    lib = cuda_lib.load()
    with torch.cuda.device(p.device):
        err = lib.qsvc_interp_down(
            cuda_lib.ptr(p), stride, p.shape[0], cuda_lib.ptr(out),
            H >> steps, W >> steps, steps, cuda_lib.stream_ptr(p))
        cuda_lib.launched("interp_down", err)
    return out
