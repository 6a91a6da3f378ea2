"""YUV 4:2:0 sequences: the frame container, raw ``.yuv`` and VIX file
I/O, synthetic test sequences and PSNR (copied from ``qsvc_tpu/io/yuv.py``).

Raw files hold 8-bit planar I420 frames back to back (name convention
``name_WxHxFPSx420xFRAMES``).  A sequence holds three arrays — Y (N,H,W)
and U,V (N,H/2,W/2) — as numpy arrays or, once uploaded, torch tensors;
the file functions take and give numpy arrays.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_NAME_RE = re.compile(r"(\d+)x(\d+)x(\d+)x420x(\d+)")


@dataclass
class Video:
    """A YUV 4:2:0 sequence. ``y``: (N,H,W) uint8; ``u``,``v``: (N,H/2,W/2)."""
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray

    @property
    def frames(self) -> int:
        return self.y.shape[0]

    @property
    def height(self) -> int:
        return self.y.shape[1]

    @property
    def width(self) -> int:
        return self.y.shape[2]

    def __getitem__(self, sl) -> "Video":
        return Video(self.y[sl], self.u[sl], self.v[sl])

    def planes(self):
        return (self.y, self.u, self.v)


def parse_geometry(filename: str) -> Optional[Tuple[int, int, int, int]]:
    """Parse W, H, FPS, frames from the reference naming convention."""
    m = _NAME_RE.search(os.path.basename(filename))
    if not m:
        return None
    w, h, fps, n = map(int, m.groups())
    return w, h, fps, n


def read_yuv(path: str, width: int, height: int,
             frames: Optional[int] = None) -> Video:
    frame_bytes = width * height * 3 // 2
    size = os.path.getsize(path)
    total = size // frame_bytes
    n = total if frames is None else min(frames, total)
    data = np.fromfile(path, dtype=np.uint8, count=n * frame_bytes)
    data = data.reshape(n, frame_bytes)
    ysz = width * height
    csz = ysz // 4
    y = data[:, :ysz].reshape(n, height, width)
    u = data[:, ysz:ysz + csz].reshape(n, height // 2, width // 2)
    v = data[:, ysz + csz:].reshape(n, height // 2, width // 2)
    return Video(y.copy(), u.copy(), v.copy())


def write_yuv(path: str, video: Video) -> None:
    n = video.frames
    with open(path, "wb") as f:
        for i in range(n):
            f.write(np.ascontiguousarray(video.y[i], dtype=np.uint8).tobytes())
            f.write(np.ascontiguousarray(video.u[i], dtype=np.uint8).tobytes())
            f.write(np.ascontiguousarray(video.v[i], dtype=np.uint8).tobytes())


def read_vix(path: str) -> Video:
    """Read a VIX container (the reference's ``vix2raw.c`` input format):
    a text header — magic line, video section (2 lines), color section
    (2 lines), image section (2 lines + ``x y c`` dims + ``c`` subsampling
    pairs) — followed by the raw planar payload."""
    with open(path, "rb") as f:
        for _ in range(7):                  # magic + 3 sections x 2 lines
            f.readline()
        dims = f.readline().split()
        x, y, c = int(dims[0]), int(dims[1]), int(dims[2])
        ss = []
        toks: list = []
        while len(toks) < 2 * c:
            toks += f.readline().split()
        for i in range(c):
            ss.append((int(toks[2 * i]), int(toks[2 * i + 1])))
        payload = f.read()
    fsz = sum((x // sx) * (y // sy) for sx, sy in ss)
    n = len(payload) // fsz
    data = np.frombuffer(payload, np.uint8, count=n * fsz).reshape(n, fsz)
    ysz = x * y
    csz = (x // ss[1][0]) * (y // ss[1][1]) if c > 1 else 0
    yv = data[:, :ysz].reshape(n, y, x)
    if c > 1:
        u = data[:, ysz:ysz + csz].reshape(n, y // ss[1][1], x // ss[1][0])
        v = data[:, ysz + csz:ysz + 2 * csz].reshape(
            n, y // ss[2][1], x // ss[2][0])
    else:
        u = np.full((n, y // 2, x // 2), 128, np.uint8)
        v = np.full((n, y // 2, x // 2), 128, np.uint8)
    return Video(yv.copy(), u.copy(), v.copy())


def vix_to_raw(in_path: str, out_path: str) -> int:
    """Strip the VIX header, writing the raw payload (``vix2raw.c:22-121``).
    Returns payload bytes written."""
    with open(in_path, "rb") as f:
        for _ in range(7):
            f.readline()
        dims = f.readline().split()
        c = int(dims[2])
        toks: list = []
        while len(toks) < 2 * c:
            toks += f.readline().split()
        payload = f.read()
    with open(out_path, "wb") as f:
        f.write(payload)
    return len(payload)


def synthetic_video(frames: int, height: int, width: int,
                    seed: int = 0, kind: str = "moving",
                    velocity: Optional[Tuple[float, float]] = None) -> Video:
    """Deterministic synthetic test sequences.

    ``moving``: textured background with translating blobs PLUS a
    temporally-static noise floor — adversarial for motion compensation
    (the noise does not follow the motion, so every MC residue carries
    ~sqrt(2)x the noise energy); ``translate``: a rigid translation of the
    whole textured scene, noise included — the temporally-redundant case a
    t+2D codec exists for (standard sequences like coastguard/container in
    the reference's tests are of this character); pass ``velocity`` as a
    float pair for fractional per-frame motion (exercises sub-pixel ME);
    ``random``: the reference's urandom calibration trick
    (``tests/Control_BR_slopes/5/urandom``); ``gradient``: smooth ramps.
    """
    rng = np.random.default_rng(seed)
    H2, W2 = height // 2, width // 2
    if kind == "random":
        return Video(
            rng.integers(0, 256, (frames, height, width), dtype=np.uint8),
            rng.integers(0, 256, (frames, H2, W2), dtype=np.uint8),
            rng.integers(0, 256, (frames, H2, W2), dtype=np.uint8))
    if kind == "translate":
        return _translating_video(frames, height, width, rng,
                                  velocity or (2.0, 1.0))
    yy, xx = np.mgrid[0:height, 0:width]
    base = (64 + 32 * np.sin(xx / 7.0) + 32 * np.sin(yy / 5.0)
            + 16 * np.sin((xx + yy) / 11.0))
    noise = rng.normal(0, 4, (height, width))
    y_frames = np.zeros((frames, height, width), np.uint8)
    u_frames = np.zeros((frames, H2, W2), np.uint8)
    v_frames = np.zeros((frames, H2, W2), np.uint8)
    cy, cx = np.mgrid[0:H2, 0:W2]
    for t in range(frames):
        if kind == "gradient":
            img = base + 2.0 * t
        else:
            dx, dy = int(round(2.1 * t)), int(round(1.3 * t))
            img = np.roll(np.roll(base, dy, axis=0), dx, axis=1) + noise
            # a bright moving square
            sy, sx = (11 + 3 * t) % (height - 16), (17 + 5 * t) % (width - 16)
            img[sy:sy + 16, sx:sx + 16] += 80
        y_frames[t] = np.clip(img, 0, 255).astype(np.uint8)
        u_frames[t] = np.clip(120 + 20 * np.sin((cx + 2 * t) / 9.0), 0, 255
                              ).astype(np.uint8)
        v_frames[t] = np.clip(130 + 20 * np.cos((cy + t) / 8.0), 0, 255
                              ).astype(np.uint8)
    return Video(y_frames, u_frames, v_frames)


def _bilinear_torus(img: np.ndarray, dy: float, dx: float) -> np.ndarray:
    """Sample ``img`` shifted by a (possibly fractional) displacement on
    the torus (periodic boundaries), bilinear interpolation."""
    iy, ix = int(np.floor(dy)), int(np.floor(dx))
    fy, fx = dy - iy, dx - ix
    a = np.roll(np.roll(img, iy, 0), ix, 1)
    b = np.roll(np.roll(img, iy, 0), ix + 1, 1)
    c = np.roll(np.roll(img, iy + 1, 0), ix, 1)
    d = np.roll(np.roll(img, iy + 1, 0), ix + 1, 1)
    return ((1 - fy) * (1 - fx) * a + (1 - fy) * fx * b
            + fy * (1 - fx) * c + fy * fx * d)


def _translating_video(frames: int, height: int, width: int, rng,
                       velocity: Tuple[float, float]) -> Video:
    """Rigid global translation of one textured noisy scene (luma and
    chroma both move; chroma at half the pixel velocity as 4:2:0 demands)."""
    H2, W2 = height // 2, width // 2
    yy, xx = np.mgrid[0:height, 0:width]
    base = (96 + 40 * np.sin(xx / 7.0) + 36 * np.sin(yy / 5.0)
            + 20 * np.sin((xx + 2 * yy) / 13.0)
            + rng.normal(0, 5, (height, width)))
    cy, cx = np.mgrid[0:H2, 0:W2]
    ubase = (120 + 24 * np.sin((cx + 2 * cy) / 9.0)
             + rng.normal(0, 2, (H2, W2)))
    vbase = (130 + 24 * np.cos((2 * cx + cy) / 8.0)
             + rng.normal(0, 2, (H2, W2)))
    vy, vx = velocity
    y = np.zeros((frames, height, width), np.uint8)
    u = np.zeros((frames, H2, W2), np.uint8)
    v = np.zeros((frames, H2, W2), np.uint8)
    for t in range(frames):
        y[t] = np.clip(_bilinear_torus(base, vy * t, vx * t), 0, 255
                       ).astype(np.uint8)
        u[t] = np.clip(_bilinear_torus(ubase, vy * t / 2, vx * t / 2),
                       0, 255).astype(np.uint8)
        v[t] = np.clip(_bilinear_torus(vbase, vy * t / 2, vx * t / 2),
                       0, 255).astype(np.uint8)
    return Video(y, u, v)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """PSNR in dB (reference delegates to the external ``snr`` tool,
    psnr.py:79-81)."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def video_psnr(a: Video, b: Video) -> Tuple[float, float, float]:
    return (psnr(a.y, b.y), psnr(a.u, b.u), psnr(a.v, b.v))
