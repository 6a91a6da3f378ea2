"""The ``moving`` content of a mix, made on the card.

A torch rewrite of the ``moving`` content of ``qsvc_tpu_torch/io/yuv.py``
(``synthetic_video``): a smooth textured background that translates by
(1.3, 2.1) pixels a frame, a bright 16x16 square moving by (3, 5), and a
sensor noise floor that stays put while the scene moves, so every motion-
compensated residue carries it; the chroma planes are slow ramps.  A
generator seeded with the mix's ``content_seed`` draws the noise, so every
run codes the same frames: runs differ only in what the run's seed
orders (the mix's entry), not in how much work the frames are.  The
frames are handed over as host uint8 arrays, as a user's frames are.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: torch.Generator seeds are unsigned 64-bit; any whole seed maps into them
_SEED_MOD = 2**64


def make(frames: int, height: int, width: int, traffic: dict, device
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(y, u, v) uint8 host arrays of ``frames`` frames of
    ``height`` x ``width`` (chroma at half size), made on ``device`` from
    the mix's ``content_seed``."""
    dev = torch.device(device)
    seed = int(traffic["content_seed"])
    gen = torch.Generator(device=dev).manual_seed(seed % _SEED_MOD)
    f32 = torch.float32
    yy = torch.arange(height, device=dev, dtype=f32)[:, None]
    xx = torch.arange(width, device=dev, dtype=f32)[None, :]
    base = (64 + 32 * torch.sin(xx / 7.0) + 32 * torch.sin(yy / 5.0)
            + 16 * torch.sin((xx + yy) / 11.0))
    noise = torch.randn((height, width), generator=gen, device=dev,
                        dtype=f32) * 4
    h2, w2 = height // 2, width // 2
    cy = torch.arange(h2, device=dev, dtype=f32)[:, None]
    cx = torch.arange(w2, device=dev, dtype=f32)[None, :]
    y = torch.empty((frames, height, width), dtype=torch.uint8, device=dev)
    u = torch.empty((frames, h2, w2), dtype=torch.uint8, device=dev)
    v = torch.empty((frames, h2, w2), dtype=torch.uint8, device=dev)
    for t in range(frames):
        dx, dy = int(round(2.1 * t)), int(round(1.3 * t))
        img = torch.roll(base, shifts=(dy, dx), dims=(0, 1)) + noise
        sy, sx = (11 + 3 * t) % (height - 16), (17 + 5 * t) % (width - 16)
        img[sy:sy + 16, sx:sx + 16] += 80
        y[t] = img.clamp(0, 255).to(torch.uint8)
        u[t] = (120 + 20 * torch.sin((cx + 2 * t) / 9.0)).expand(
            h2, w2).clamp(0, 255).to(torch.uint8)
        v[t] = (130 + 20 * torch.cos((cy + t) / 8.0)).expand(
            h2, w2).clamp(0, 255).to(torch.uint8)
    return y.cpu().numpy(), u.cpu().numpy(), v.cpu().numpy()
