"""ctypes bridge to the native EBCOT coder.

Port of ``qsvc_tpu/codec/fast.py``.  The library is built on first use
from the port's own copy of the C++ coder, ``qsvc_tpu_torch/native/
ebcot.cpp``, with ``g++ -O3 -fopenmp`` into
``qsvc_tpu_torch/_build/libqsvc.so``.  The copy is byte-identical to the
JAX package's ``qsvc_tpu/native/ebcot.cpp`` (a test holds the two
together), so both packages write the same stream format and each
decodes the other's containers.  There is no fallback: every function
here calls the library, and a failed build raises with the compiler's
output.  :func:`available` only reports whether the library builds and
loads.  The pure-Python spec twin is :mod:`.tier1`, reached by name.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .tier1 import CodeblockStream

_BAND_CODE = {"LL": 0, "LH": 0, "HL": 1, "HH": 2}
_MAX_PASSES = 3 * 64 + 1

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PATH = os.path.join(_PKG_DIR, "native", "ebcot.cpp")
SO_PATH = os.path.join(_PKG_DIR, "_build", "libqsvc.so")

_lib = None
_lib_lock = threading.Lock()


def _build() -> str:
    so, src = SO_PATH, SRC_PATH
    if (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(src)):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    errors = []
    for extra in (["-mbmi2"], []):   # BMI2 PEXT/PDEP fast path if available
        cmd = ["g++", "-O3", *extra, "-fopenmp", "-shared", "-fPIC", src,
               "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode == 0:
            os.replace(tmp, so)    # atomic: concurrent builders never see
            return so              # a half-written library
        errors.append(f"{' '.join(cmd)}\n{proc.stderr}")
    raise RuntimeError("building the native EBCOT coder failed:\n"
                       + "\n".join(errors))


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.qsvc_encode_block.restype = ctypes.c_int
            lib.qsvc_decode_block.restype = ctypes.c_int
            _lib = lib
    return _lib


def build_seconds() -> float:
    """Build (if needed) and load the library; returns seconds taken."""
    t0 = time.time()
    _load()
    return time.time() - t0


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def encode_codeblock(coeffs: np.ndarray, band: str) -> CodeblockStream:
    lib = _load()
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int64)
    h, w = coeffs.shape
    cap = max(4 * h * w * 8, 1 << 14)
    out = np.empty(cap, np.uint8)
    msbs = ctypes.c_int()
    npass = ctypes.c_int()
    ends = np.zeros(_MAX_PASSES, np.int32)
    dist = np.zeros(_MAX_PASSES, np.float64)
    dist0 = ctypes.c_double()
    total = lib.qsvc_encode_block(
        coeffs.ctypes.data_as(ctypes.c_void_p), h, w, _BAND_CODE[band],
        out.ctypes.data_as(ctypes.c_void_p), cap,
        ctypes.byref(msbs), ctypes.byref(npass),
        ends.ctypes.data_as(ctypes.c_void_p),
        dist.ctypes.data_as(ctypes.c_void_p), ctypes.byref(dist0))
    if total < 0:
        raise RuntimeError(f"code-block {h}x{w} exceeds {cap} bytes")
    n = npass.value
    return CodeblockStream(bytes(out[:total]), msbs.value,
                           ends[:n].tolist(), dist[:n].tolist(),
                           dist0.value, (h, w), band)


def decode_codeblock(data: bytes, msbs: int, num_passes: int,
                     shape: Tuple[int, int], band: str,
                     pass_ends: Optional[List[int]] = None) -> np.ndarray:
    """Decode (possibly truncated) code-block data: the native twin of
    :func:`.tier1.decode_codeblock`."""
    lib = _load()
    h, w = shape
    out = np.zeros(h * w, np.int64)
    ends = np.asarray(pass_ends or [len(data)], np.int32)
    buf = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    lib.qsvc_decode_block(
        buf.ctypes.data_as(ctypes.c_void_p), len(data), msbs, num_passes,
        ends.ctypes.data_as(ctypes.c_void_p), len(ends),
        h, w, _BAND_CODE[band],
        out.ctypes.data_as(ctypes.c_void_p))
    return out.reshape(h, w)


def encode_codeblocks_batch(tiles: Sequence[np.ndarray],
                            bands: Sequence[str],
                            min_slopes: Optional[Sequence[float]] = None
                            ) -> List[CodeblockStream]:
    """OpenMP-parallel batch encode.

    ``min_slopes``: optional per-block early-stop threshold (unweighted
    SSE-per-byte): planes whose slope falls below it are not coded — they
    could never survive truncation at that threshold.
    """
    lib = _load()
    nb = len(tiles)
    if nb == 0:
        return []
    sizes = [t.size for t in tiles]
    offsets = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int32)
    flat = np.concatenate([np.ascontiguousarray(t, np.int64).ravel()
                           for t in tiles])
    hs = np.asarray([t.shape[0] for t in tiles], np.int32)
    ws = np.asarray([t.shape[1] for t in tiles], np.int32)
    bc = np.asarray([_BAND_CODE[b] for b in bands], np.int32)
    # int64 path may carry deep magnitudes (motion residues): keep 16x
    out_stride = max(16 * int(max(sizes)), 1 << 13)
    out = np.empty((nb, out_stride), np.uint8)
    out_lens = np.zeros(nb, np.int32)
    msbs = np.zeros(nb, np.int32)
    npass = np.zeros(nb, np.int32)
    ends = np.zeros((nb, _MAX_PASSES), np.int32)
    dist = np.zeros((nb, _MAX_PASSES), np.float64)
    dist0 = np.zeros(nb, np.float64)
    if min_slopes is not None:
        ms = np.ascontiguousarray(min_slopes, np.float64)
        ms_ptr = ms.ctypes.data_as(ctypes.c_void_p)
    else:
        ms_ptr = None
    lib.qsvc_encode_blocks(
        flat.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        hs.ctypes.data_as(ctypes.c_void_p),
        ws.ctypes.data_as(ctypes.c_void_p),
        bc.ctypes.data_as(ctypes.c_void_p), nb,
        out.ctypes.data_as(ctypes.c_void_p), out_stride,
        out_lens.ctypes.data_as(ctypes.c_void_p),
        msbs.ctypes.data_as(ctypes.c_void_p),
        npass.ctypes.data_as(ctypes.c_void_p),
        ends.ctypes.data_as(ctypes.c_void_p), _MAX_PASSES,
        dist.ctypes.data_as(ctypes.c_void_p),
        dist0.ctypes.data_as(ctypes.c_void_p),
        ms_ptr)
    res = []
    for i in range(nb):
        if out_lens[i] < 0:   # cap exceeded: redo solo with a large buffer
            res.append(encode_codeblock(tiles[i].astype(np.int64), bands[i]))
            continue
        n = int(npass[i])
        res.append(CodeblockStream(
            bytes(out[i, :out_lens[i]]), int(msbs[i]),
            ends[i, :n].tolist(), dist[i, :n].tolist(),
            float(dist0[i]), (int(hs[i]), int(ws[i])), bands[i]))
    return res


def encode_packed_planes(planes: np.ndarray,
                         tiles_meta: Sequence[Tuple[int, int, int, int, int]],
                         bands: Sequence[str],
                         min_slopes: Optional[Sequence[float]] = None,
                         coder: str = "mq") -> List[CodeblockStream]:
    """Encode code-blocks directly out of a packed (N, H, W) int16/int32
    DWT-plane stack — zero per-tile copies.

    ``tiles_meta``: per block (frame_idx, y0_abs, x0_abs, h, w) where the
    coordinates are absolute within the packed plane.
    ``coder``: "mq" (spec-style context-adaptive MQ) or "bp" (bit-parallel
    throughput mode; requires the native library).
    """
    lib = _load()
    nb = len(tiles_meta)
    if nb == 0:
        return []
    planes = np.ascontiguousarray(planes)
    N, H, W = planes.shape
    if planes.dtype not in (np.int16, np.int32):
        tiles = [planes[n, y0:y0 + th, x0:x0 + tw].astype(np.int64)
                 for (n, y0, x0, th, tw) in tiles_meta]
        if coder == "bp":
            return _bp_encode_tiles(tiles, min_slopes)
        return encode_codeblocks_batch(tiles, bands, min_slopes)
    offsets = np.asarray([(n * H + y0) * W + x0
                          for (n, y0, x0, _, _) in tiles_meta], np.int64)
    hs = np.asarray([t[3] for t in tiles_meta], np.int32)
    ws = np.asarray([t[4] for t in tiles_meta], np.int32)
    bc = np.asarray([_BAND_CODE[b] for b in bands], np.int32)
    max_sz = int((hs.astype(np.int64) * ws.astype(np.int64)).max())
    # worst case ~2 bits/coef/plane + per-pass padding; 8x coefficient
    # count (=64 bits/coef) is unreachable, and keeping the buffer small
    # matters: a huge np.empty costs page faults on first write
    out_stride = max(8 * max_sz, 1 << 13)
    out = np.empty((nb, out_stride), np.uint8)
    out_lens = np.zeros(nb, np.int32)
    msbs = np.zeros(nb, np.int32)
    npass = np.zeros(nb, np.int32)
    ends = np.zeros((nb, _MAX_PASSES), np.int32)
    dist = np.zeros((nb, _MAX_PASSES), np.float64)
    dist0 = np.zeros(nb, np.float64)
    if min_slopes is not None:
        ms = np.ascontiguousarray(min_slopes, np.float64)
        ms_ptr = ms.ctypes.data_as(ctypes.c_void_p)
    else:
        ms_ptr = None
    if coder == "bp":
        fn = (lib.qsvc_bp_encode_blocks_s16 if planes.dtype == np.int16
              else lib.qsvc_bp_encode_blocks_s32)
    else:
        fn = (lib.qsvc_encode_blocks_s16 if planes.dtype == np.int16
              else lib.qsvc_encode_blocks_s32)
    fn(planes.ctypes.data_as(ctypes.c_void_p),
       offsets.ctypes.data_as(ctypes.c_void_p), W,
       hs.ctypes.data_as(ctypes.c_void_p),
       ws.ctypes.data_as(ctypes.c_void_p),
       bc.ctypes.data_as(ctypes.c_void_p), nb,
       out.ctypes.data_as(ctypes.c_void_p), out_stride,
       out_lens.ctypes.data_as(ctypes.c_void_p),
       msbs.ctypes.data_as(ctypes.c_void_p),
       npass.ctypes.data_as(ctypes.c_void_p),
       ends.ctypes.data_as(ctypes.c_void_p), _MAX_PASSES,
       dist.ctypes.data_as(ctypes.c_void_p),
       dist0.ctypes.data_as(ctypes.c_void_p),
       ms_ptr)
    res = []
    for i in range(nb):
        if out_lens[i] < 0:   # cap exceeded (pathological block): redo solo
            n, y0, x0, th, tw = tiles_meta[i]
            tile = planes[n, y0:y0 + th, x0:x0 + tw].astype(np.int64)
            if coder == "bp":
                res.append(_bp_encode_tiles(
                    [tile], [min_slopes[i]] if min_slopes is not None
                    else None)[0])
            else:
                res.append(encode_codeblock(tile, bands[i]))
            continue
        n = int(npass[i])
        res.append(CodeblockStream(
            bytes(out[i, :out_lens[i]]), int(msbs[i]),
            ends[i, :n].tolist(), dist[i, :n].tolist(),
            float(dist0[i]), (int(hs[i]), int(ws[i])), bands[i]))
    return res


def _bp_encode_tiles(tiles: Sequence[np.ndarray],
                     min_slopes: Optional[Sequence[float]] = None
                     ) -> List[CodeblockStream]:
    """bp-encode loose int64 tiles (test/utility path)."""
    lib = _load()
    out = []
    for i, t in enumerate(tiles):
        t = np.ascontiguousarray(t, np.int64)
        h, w = t.shape
        cap = max(4 * h * w * 8, 1 << 14)
        buf = np.empty(cap, np.uint8)
        lens = np.zeros(1, np.int32)
        msbs = np.zeros(1, np.int32)
        npass = np.zeros(1, np.int32)
        ends = np.zeros(_MAX_PASSES, np.int32)
        dist = np.zeros(_MAX_PASSES, np.float64)
        dist0 = np.zeros(1, np.float64)
        off = np.zeros(1, np.int64)
        hs = np.asarray([h], np.int32)
        ws = np.asarray([w], np.int32)
        bc = np.zeros(1, np.int32)
        ms = (np.asarray([min_slopes[i]], np.float64)
              if min_slopes is not None else None)
        lib.qsvc_bp_encode_blocks_i64(
            t.ctypes.data_as(ctypes.c_void_p),
            off.ctypes.data_as(ctypes.c_void_p), w,
            hs.ctypes.data_as(ctypes.c_void_p),
            ws.ctypes.data_as(ctypes.c_void_p),
            bc.ctypes.data_as(ctypes.c_void_p), 1,
            buf.ctypes.data_as(ctypes.c_void_p), cap,
            lens.ctypes.data_as(ctypes.c_void_p),
            msbs.ctypes.data_as(ctypes.c_void_p),
            npass.ctypes.data_as(ctypes.c_void_p),
            ends.ctypes.data_as(ctypes.c_void_p), _MAX_PASSES,
            dist.ctypes.data_as(ctypes.c_void_p),
            dist0.ctypes.data_as(ctypes.c_void_p),
            ms.ctypes.data_as(ctypes.c_void_p) if ms is not None else None)
        n = int(npass[0])
        out.append(CodeblockStream(bytes(buf[:lens[0]]), int(msbs[0]),
                                   ends[:n].tolist(), dist[:n].tolist(),
                                   float(dist0[0]), (h, w), "LL"))
    return out


def bp_decode_tiles(blocks) -> List[np.ndarray]:
    """bp-decode loose tiles: (data, msbs, num_passes, shape) tuples."""
    lib = _load()
    res = []
    for (data, msbs, npass, shape) in blocks:
        h, w = shape
        out = np.zeros(h * w, np.int64)
        buf = (np.frombuffer(data, np.uint8) if data
               else np.zeros(1, np.uint8))
        off = np.zeros(1, np.int64)
        lens = np.asarray([len(data)], np.int32)
        ms = np.asarray([msbs], np.int32)
        np_ = np.asarray([npass], np.int32)
        hs = np.asarray([h], np.int32)
        ws = np.asarray([w], np.int32)
        bc = np.zeros(1, np.int32)
        oo = np.zeros(1, np.int32)
        lib.qsvc_bp_decode_blocks_i64(
            buf.ctypes.data_as(ctypes.c_void_p),
            off.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            ms.ctypes.data_as(ctypes.c_void_p),
            np_.ctypes.data_as(ctypes.c_void_p),
            None, None, 0,
            hs.ctypes.data_as(ctypes.c_void_p),
            ws.ctypes.data_as(ctypes.c_void_p),
            bc.ctypes.data_as(ctypes.c_void_p), 1,
            out.ctypes.data_as(ctypes.c_void_p),
            oo.ctypes.data_as(ctypes.c_void_p))
        res.append(out.reshape(h, w))
    return res


def decode_packed_planes(blocks, positions, out: np.ndarray,
                         coder: str = "mq") -> None:
    """Batch-decode code-blocks directly INTO a packed (N, H, W) int32
    plane stack.

    ``blocks``: (data, msbs, num_passes, shape, band, pass_ends) tuples;
    ``positions``: per block (frame_idx, y0_abs, x0_abs).
    """
    lib = _load()
    N, H, W = out.shape
    if out.dtype != np.int32:
        if coder == "bp":
            tiles = bp_decode_tiles([(b[0], b[1], b[2], b[3])
                                     for b in blocks])
        else:
            tiles = decode_codeblocks_batch(blocks)
        for (n, y0, x0), b, tile in zip(positions, blocks, tiles):
            th, tw = b[3]
            out[n, y0:y0 + th, x0:x0 + tw] = tile
        return
    nb = len(blocks)
    if nb == 0:
        return
    datas = [b[0] for b in blocks]
    lens = np.asarray([len(d) for d in datas], np.int64)
    data_off = np.zeros(nb, np.int64)
    np.cumsum(lens[:-1], out=data_off[1:])
    flat = (np.frombuffer(b"".join(datas), np.uint8)
            if any(lens) else np.zeros(1, np.uint8))
    msbs = np.asarray([b[1] for b in blocks], np.int32)
    npass = np.asarray([b[2] for b in blocks], np.int32)
    hs = np.asarray([b[3][0] for b in blocks], np.int32)
    ws = np.asarray([b[3][1] for b in blocks], np.int32)
    bc = np.asarray([_BAND_CODE[b[4]] for b in blocks], np.int32)
    ends = np.zeros((nb, _MAX_PASSES), np.int32)
    n_ends = np.zeros(nb, np.int32)
    for i, b in enumerate(blocks):
        pe = b[5] or [len(datas[i])]
        n_ends[i] = len(pe)
        ends[i, :len(pe)] = pe
    out_off = np.asarray([(n * H + y0) * W + x0
                          for (n, y0, x0) in positions], np.int64)
    lens32 = lens.astype(np.int32)
    dec_fn = (lib.qsvc_bp_decode_blocks_s32 if coder == "bp"
              else lib.qsvc_decode_blocks_s32)
    dec_fn(
        flat.ctypes.data_as(ctypes.c_void_p),
        data_off.ctypes.data_as(ctypes.c_void_p),
        lens32.ctypes.data_as(ctypes.c_void_p),
        msbs.ctypes.data_as(ctypes.c_void_p),
        npass.ctypes.data_as(ctypes.c_void_p),
        ends.ctypes.data_as(ctypes.c_void_p),
        n_ends.ctypes.data_as(ctypes.c_void_p), _MAX_PASSES,
        hs.ctypes.data_as(ctypes.c_void_p),
        ws.ctypes.data_as(ctypes.c_void_p),
        bc.ctypes.data_as(ctypes.c_void_p), nb,
        out.ctypes.data_as(ctypes.c_void_p),
        out_off.ctypes.data_as(ctypes.c_void_p), W)


def decode_codeblocks_batch(blocks) -> List[np.ndarray]:
    """Batch decode of (data, msbs, num_passes, shape, band, pass_ends)
    tuples with OpenMP."""
    lib = _load()
    nb = len(blocks)
    if nb == 0:
        return []
    datas = [b[0] for b in blocks]
    lens = np.asarray([len(d) for d in datas], np.int64)
    data_off = np.zeros(nb, np.int64)
    np.cumsum(lens[:-1], out=data_off[1:])
    flat = (np.frombuffer(b"".join(datas), np.uint8)
            if any(lens) else np.zeros(1, np.uint8))
    msbs = np.asarray([b[1] for b in blocks], np.int32)
    npass = np.asarray([b[2] for b in blocks], np.int32)
    hs = np.asarray([b[3][0] for b in blocks], np.int32)
    ws = np.asarray([b[3][1] for b in blocks], np.int32)
    bc = np.asarray([_BAND_CODE[b[4]] for b in blocks], np.int32)
    ends = np.zeros((nb, _MAX_PASSES), np.int32)
    n_ends = np.zeros(nb, np.int32)
    for i, b in enumerate(blocks):
        pe = b[5] or [len(datas[i])]
        n_ends[i] = len(pe)
        ends[i, :len(pe)] = pe
    sizes = (hs.astype(np.int64) * ws.astype(np.int64))
    out_off = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int32)
    out = np.zeros(int(sizes.sum()), np.int64)
    lens32 = lens.astype(np.int32)
    lib.qsvc_decode_blocks(
        flat.ctypes.data_as(ctypes.c_void_p),
        data_off.ctypes.data_as(ctypes.c_void_p),
        lens32.ctypes.data_as(ctypes.c_void_p),
        msbs.ctypes.data_as(ctypes.c_void_p),
        npass.ctypes.data_as(ctypes.c_void_p),
        ends.ctypes.data_as(ctypes.c_void_p),
        n_ends.ctypes.data_as(ctypes.c_void_p), _MAX_PASSES,
        hs.ctypes.data_as(ctypes.c_void_p),
        ws.ctypes.data_as(ctypes.c_void_p),
        bc.ctypes.data_as(ctypes.c_void_p), nb,
        out.ctypes.data_as(ctypes.c_void_p),
        out_off.ctypes.data_as(ctypes.c_void_p))
    return [out[out_off[i]:out_off[i] + sizes[i]].reshape(hs[i], ws[i])
            for i in range(nb)]
