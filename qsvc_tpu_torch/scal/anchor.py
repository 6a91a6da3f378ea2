"""External quality anchor: OpenJPEG intra-frame J2K coding.

Copy of ``qsvc_tpu/scal/anchor.py`` (host code; Pillow only).

The reference's quality evidence is RD curves against external codecs
(``trunk/tests/RD-*.sh``: H.264/SVC, x264, MPEG, MJ2K); its own texture
coding quality *is* Kakadu (``texture_compress_fb_j2k.py:183-196``).  The
available third-party stand-in in this environment is OpenJPEG (via
Pillow), already the interop oracle for the Tier-1/Tier-2 stack
(tests/test_j2k_interop.py).  This module codes every frame of a video
as an independent lossy 9/7 J2K image at a target compression ratio —
the "Motion-JPEG2000 / MJ2K" operating mode of the reference
(``texture_compress_fb_mj2k.py``, ``trunk/readme.txt:37``) — giving an
external, independently-implemented RD baseline that the MCTF codec must
beat on temporally-redundant content (the temporal transform is its
entire reason to exist).
"""

from __future__ import annotations

import io
from typing import Tuple

import numpy as np

from ..io.yuv import Video, video_psnr


def available() -> bool:
    try:
        from PIL import features
        return bool(features.check("jpg_2000"))
    except Exception:
        return False


def _encode_plane(plane: np.ndarray, ratio: float, levels: int) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(plane).save(
        buf, "JPEG2000", quality_mode="rates",
        quality_layers=[max(1.0, float(ratio))], irreversible=True,
        num_resolutions=levels)
    return buf.getvalue()


def _decode_plane(data: bytes) -> np.ndarray:
    from PIL import Image
    return np.array(Image.open(io.BytesIO(data)))


def encode_intra(video: Video, ratio: float, levels: int = 5
                 ) -> Tuple[int, Video]:
    """Code every frame/component as an independent lossy J2K image at
    compression ``ratio`` (raw bytes / coded bytes, OpenJPEG's rate
    allocator).  Returns (total coded bytes, decoded video)."""
    total = 0
    planes = []
    for pl in (video.y, video.u, video.v):
        pl = np.asarray(pl)
        decs = []
        for t in range(pl.shape[0]):
            data = _encode_plane(pl[t], ratio, levels)
            total += len(data)
            decs.append(_decode_plane(data))
        planes.append(np.stack(decs).astype(np.uint8))
    return total, Video(*planes)


def match_rate(video: Video, target_bytes: int, levels: int = 5,
               tol: float = 0.05, max_iter: int = 12
               ) -> Tuple[int, Video, float]:
    """Binary-search the compression ratio whose total coded size lands
    within ``tol`` of ``target_bytes`` (never above ``(1+tol)*target``):
    the matched-rate point for a fair PSNR comparison.  Returns
    (bytes, decoded video, ratio)."""
    raw = np.asarray(video.y).size * 3 // 2
    ratio = max(1.0, raw / max(target_bytes, 1))
    lo, hi = 1.0, None
    best = None
    for _ in range(max_iter):
        n, dec = encode_intra(video, ratio, levels)
        if best is None or (n <= target_bytes * (1 + tol)
                            and abs(n - target_bytes) <
                            abs(best[0] - target_bytes)):
            if n <= target_bytes * (1 + tol):
                best = (n, dec, ratio)
        if abs(n - target_bytes) <= tol * target_bytes:
            return n, dec, ratio
        if n > target_bytes:      # too big -> compress more
            lo = ratio
            ratio = ratio * 2 if hi is None else 0.5 * (ratio + hi)
        else:
            hi = ratio
            ratio = 0.5 * (ratio + lo)
    if best is not None:
        return best
    return n, dec, ratio


def psnr_y(a: Video, b: Video) -> float:
    return video_psnr(a, b)[0]
