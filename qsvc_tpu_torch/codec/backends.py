"""Alternative texture-codec backends (the reference's codec registry).

Port of ``qsvc_tpu/codec/backends.py``.  The reference selects its
per-subband-frame texture codec through env vars and adapter scripts —
``mcj2k``/``mcmj2k``/``mcmjpeg``/``mcltw``/``mccp`` profiles dispatching
to ``texture_compress_fb_<codec>`` (mcj2k.sh:53-66,
texture_compress.py:39) — all of them shelling out to external binaries
(Kakadu, ffmpeg, ltw, plain ``cp``).  This module is the in-framework
equivalent: a registry of per-plane codecs the MCTF texture path can
swap in for the default codec ("internal", the DWT+EBCOT path of
frame_codec):

* ``cp``    — identity/raw store (the reference's ``mccp`` profile);
* ``zlib``  — lossless DEFLATE (the reference's gzip role, which it
  only offered for motion; here usable for texture too);
* ``j2k``   — per-frame LOSSLESS standard JPEG 2000 via
  :mod:`.j2k` (the reference's MJ2K mode, Motion-JPEG2000 as
  independent per-frame code-streams);
* ``mj2k``  — per-frame LOSSY 9/7 standard JPEG 2000 (quality mapped
  from the reference's slope units);
* ``mjpeg`` — per-frame baseline JPEG (the reference's ``mcmjpeg``
  profile, which shells out to ffmpeg for per-frame JPEGs);
* ``ltw``   — standalone per-frame wavelet intra coder with
  self-contained streams (the role of the external LTW binary in the
  reference's ``mcltw`` profile), here the in-framework 9/7+EBCOT
  coder serialized frame by frame.

Encoding is always self-contained (our own encoders).  The two J2K
backends DECODE through OpenJPEG (Pillow), and the J2K and JPEG
backends are registered only when Pillow has the codec.

Every backend's ``encode(plane, quality, *, device)`` and
``decode(data, H, W, *, device)`` take the device the caller runs on:
``ltw`` runs its texture DWT there, the host codecs ignore it.

Alternative backends trade away the internal container's pass-level
R-D metadata, so QS extraction passes their frames through untouched
(exactly the reference's situation: slope truncation is a J2K-codec
feature).  TS extraction (dropping whole temporal levels) still works.
"""

from __future__ import annotations

import io
import struct
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np


@dataclass
class BackendFrame:
    """One plane coded by an alternative backend."""
    backend: str
    H: int
    W: int
    payload: bytes

    @property
    def total_bytes(self) -> int:
        return len(self.payload)

    # container/extraction protocol compatibility (EncodedFrame duck type)
    def truncate(self, threshold: float) -> "BackendFrame":
        return self                     # not slope-truncatable (see module doc)

    @property
    def num_passes(self) -> int:
        return 1


class Backend:
    def __init__(self, name: str,
                 encode: Callable[..., bytes],
                 decode: Callable[..., np.ndarray],
                 lossless: bool):
        self.name = name
        self.encode = encode
        self.decode = decode
        self.lossless = lossless


_REGISTRY: Dict[str, Backend] = {}


def register(backend: Backend) -> None:
    _REGISTRY[backend.name] = backend


def get(name: str) -> Backend:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown texture backend {name!r}; available: "
            f"{sorted(_REGISTRY)} (j2k/mj2k need Pillow+OpenJPEG)")
    return _REGISTRY[name]


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ----------------------------------------------------------------- cp

def _cp_encode(plane: np.ndarray, quality: float, *, device) -> bytes:
    return np.ascontiguousarray(plane, np.uint8).tobytes()


def _cp_decode(data: bytes, H: int, W: int, *, device) -> np.ndarray:
    return np.frombuffer(data, np.uint8).reshape(H, W)


register(Backend("cp", _cp_encode, _cp_decode, lossless=True))


# --------------------------------------------------------------- zlib

def _zlib_encode(plane: np.ndarray, quality: float, *, device) -> bytes:
    return zlib.compress(np.ascontiguousarray(plane, np.uint8).tobytes(),
                         6)


def _zlib_decode(data: bytes, H: int, W: int, *, device) -> np.ndarray:
    return np.frombuffer(zlib.decompress(data), np.uint8).reshape(H, W)


register(Backend("zlib", _zlib_encode, _zlib_decode, lossless=True))


# ----------------------------------------------------------- j2k/mj2k

def _pil_available() -> bool:
    try:
        from PIL import features
        return bool(features.check("jpg_2000"))
    except Exception:
        return False


def _j2k_decode(data: bytes, H: int, W: int, *, device) -> np.ndarray:
    from PIL import Image
    arr = np.array(Image.open(io.BytesIO(data)))
    assert arr.shape == (H, W), (arr.shape, H, W)
    return arr.astype(np.uint8)


def _j2k_encode(plane: np.ndarray, quality: float, *, device) -> bytes:
    from . import j2k
    return j2k.encode_j2c(np.ascontiguousarray(plane, np.uint8),
                          levels=3, cb=64)


def _mj2k_encode(plane: np.ndarray, quality: float, *, device) -> bytes:
    from . import j2k
    from .frame_codec import slope_to_threshold
    # map the reference's slope units to a 9/7 base step, the same rule
    # the internal path uses for its quantizer (api._operating_point)
    if quality and quality > 0:
        import math
        t = slope_to_threshold(float(quality))
        bd = float(np.clip(math.sqrt(t) / 8.0, 0.125, 8.0))
    else:
        bd = 0.125
    return j2k.encode_j2c(np.ascontiguousarray(plane, np.uint8),
                          levels=3, cb=64, reversible=False,
                          base_delta=bd)


if _pil_available():
    register(Backend("j2k", _j2k_encode, _j2k_decode, lossless=True))
    register(Backend("mj2k", _mj2k_encode, _j2k_decode, lossless=False))


# -------------------------------------------------------------- mjpeg

def _jpeg_available() -> bool:
    try:
        from PIL import features
        return bool(features.check("jpg"))
    except Exception:
        return False


def _mjpeg_encode(plane: np.ndarray, quality: float, *, device) -> bytes:
    """Per-frame baseline JPEG — the reference's ``mcmjpeg`` profile
    codes each subband frame as an independent JPEG through ffmpeg
    (texture_compress_*_mjpeg.py); slope units map linearly onto the
    JPEG quality scale over the useful 42000..46000 range."""
    from PIL import Image
    if quality and quality > 0:
        q = int(np.clip(95 - (float(quality) - 42000.0) / 4000.0 * 85.0,
                        5, 95))
    else:
        q = 90
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(plane, np.uint8), "L").save(
        buf, "JPEG", quality=q)
    return buf.getvalue()


def _mjpeg_decode(data: bytes, H: int, W: int, *, device) -> np.ndarray:
    from PIL import Image
    arr = np.array(Image.open(io.BytesIO(data)).convert("L"))
    assert arr.shape == (H, W), (arr.shape, H, W)
    return arr.astype(np.uint8)


if _jpeg_available():
    register(Backend("mjpeg", _mjpeg_encode, _mjpeg_decode,
                     lossless=False))


# ---------------------------------------------------------------- ltw

def _ltw_encode(plane: np.ndarray, quality: float, *, device) -> bytes:
    """Standalone per-frame wavelet coder — the role the external LTW
    binary plays in the reference's ``mcltw`` profile (an alternative
    intra wavelet codec with its own self-contained per-frame streams,
    texture_compress_*_ltw.py).  Here: the in-framework 9/7 DWT + EBCOT
    intra coder on ``device``, one serialized EncodedFrame per plane (no
    shared container metadata, so the stream is decodable frame by
    frame)."""
    from . import codestream, frame_codec
    t = (frame_codec.slope_to_threshold(float(quality))
         if quality and quality > 0 else 0.0)
    ef = frame_codec.encode_frame(np.asarray(plane, np.int32), levels=3,
                                  reversible=False, delta=0.125,
                                  codeblock_size=64, device=device)
    if t > 0:
        ef = ef.truncate(t)
    out = bytearray()
    codestream._write_frame(out, ef)
    return bytes(out)


def _ltw_decode(data: bytes, H: int, W: int, *, device) -> np.ndarray:
    from . import codestream, frame_codec
    ef = codestream._read_frame(codestream._Reader(data))
    rec = frame_codec.decode_frame(ef, device=device)
    assert rec.shape == (H, W), (rec.shape, H, W)
    return np.clip(rec, 0, 255).astype(np.uint8)


register(Backend("ltw", _ltw_encode, _ltw_decode, lossless=False))


# ------------------------------------------------- (de)serialization

def write_frame(out: bytearray, bf: BackendFrame, wvarint) -> None:
    name = bf.backend.encode()
    out += struct.pack("<B", len(name))
    out += name
    out += struct.pack("<HH", bf.H, bf.W)
    wvarint(out, len(bf.payload))
    out += bf.payload


def read_frame(r) -> BackendFrame:
    (nlen,) = r.struct("<B")
    name = bytes(r.bytes_(nlen)).decode()
    H, W = r.struct("<HH")
    n = r.varint()
    return BackendFrame(name, H, W, bytes(r.bytes_(n)))
