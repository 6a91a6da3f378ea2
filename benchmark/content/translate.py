"""The ``translate`` content of a mix, made on the card.

A torch rewrite of the ``translate`` content of
``qsvc_tpu_torch/io/yuv.py`` (``synthetic_video``): one textured scene
with its noise, shifted rigidly on the torus by the mix's velocity
(``velocity_y``, ``velocity_x``, pixels a frame, fractional shifts
sampled bilinearly), the chroma planes at half the velocity as 4:2:0
demands.  The whole scene moves, noise included, so a motion search at
sub-pixel accuracy finds the fractional shift.  A generator seeded with
the mix's ``content_seed`` draws the noise, so every run codes the same
frames.  The frames are handed over as host uint8 arrays, as a user's
frames are.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

#: torch.Generator seeds are unsigned 64-bit; any whole seed maps into them
_SEED_MOD = 2**64


def shift(img: torch.Tensor, dy: float, dx: float) -> torch.Tensor:
    """``img`` shifted by (``dy``, ``dx``) pixels on the torus, sampled
    bilinearly between its four whole-pixel neighbours."""
    iy, ix = math.floor(dy), math.floor(dx)
    fy, fx = dy - iy, dx - ix

    def at(sy, sx):
        return torch.roll(img, shifts=(sy, sx), dims=(0, 1))
    return ((1 - fy) * (1 - fx) * at(iy, ix) + (1 - fy) * fx * at(iy, ix + 1)
            + fy * (1 - fx) * at(iy + 1, ix) + fy * fx * at(iy + 1, ix + 1))


def make(frames: int, height: int, width: int, traffic: dict, device
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(y, u, v) uint8 host arrays of ``frames`` frames of
    ``height`` x ``width`` (chroma at half size), made on ``device`` from
    the mix's ``content_seed`` and velocity."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(
        int(traffic["content_seed"]) % _SEED_MOD)
    f32 = torch.float32
    vy, vx = float(traffic["velocity_y"]), float(traffic["velocity_x"])

    def grid(h, w):
        return (torch.arange(h, device=dev, dtype=f32)[:, None],
                torch.arange(w, device=dev, dtype=f32)[None, :])

    def noise(h, w, sigma):
        return torch.randn((h, w), generator=gen, device=dev,
                           dtype=f32) * sigma
    yy, xx = grid(height, width)
    base = (96 + 40 * torch.sin(xx / 7.0) + 36 * torch.sin(yy / 5.0)
            + 20 * torch.sin((xx + 2 * yy) / 13.0) + noise(height, width, 5))
    h2, w2 = height // 2, width // 2
    cy, cx = grid(h2, w2)
    ubase = 120 + 24 * torch.sin((cx + 2 * cy) / 9.0) + noise(h2, w2, 2)
    vbase = 130 + 24 * torch.cos((2 * cx + cy) / 8.0) + noise(h2, w2, 2)
    y = torch.empty((frames, height, width), dtype=torch.uint8, device=dev)
    u = torch.empty((frames, h2, w2), dtype=torch.uint8, device=dev)
    v = torch.empty((frames, h2, w2), dtype=torch.uint8, device=dev)
    for t in range(frames):
        y[t] = shift(base, vy * t, vx * t).clamp(0, 255).to(torch.uint8)
        u[t] = shift(ubase, vy * t / 2, vx * t / 2).clamp(0, 255).to(
            torch.uint8)
        v[t] = shift(vbase, vy * t / 2, vx * t / 2).clamp(0, 255).to(
            torch.uint8)
    return y.cpu().numpy(), u.cpu().numpy(), v.cpu().numpy()
