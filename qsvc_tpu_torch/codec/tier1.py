"""EBCOT Tier-1 code-block bit-plane coder (JPEG 2000 / T.800 Annex D
semantics).

Port of ``qsvc_tpu/codec/tier1.py``: sign-magnitude bit-plane coding of
one code-block with the three coding passes (significance propagation,
magnitude refinement, cleanup with run-length mode), the standard
19-context model, and the MQ coder from :mod:`.mq`, in pure Python with
numpy.

Every coding pass is terminated (TERMALL-style), so pass boundaries are
exact byte offsets — quality-layer formation and truncation are pure byte
slicing, and passes of different code-blocks decode independently and in
parallel.  Per-pass squared-error distortion is recorded during encoding.

This is the spec twin of the native coder that :mod:`.fast` binds and
the codec runs; the two write the same bytes.  :class:`CodeblockStream`
is the record both return.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .mq import MQDecoder, MQEncoder, CTX_RUNLENGTH, CTX_UNIFORM

# --- context LUTs (T.800 Tables D.1, D.2, D.3 structure) -------------------

_SIGN_CTX = {}
_SIGN_XOR = {}
for _h in (-1, 0, 1):
    for _v in (-1, 0, 1):
        if _h == 0 and _v == 0:
            c, x = 9, 0
        elif _h == 0:
            c, x = 10, (_v < 0)
        elif _h == 1:
            c, x = (13 if _v == 1 else 12 if _v == 0 else 11), 0
        else:  # _h == -1
            c, x = (11 if _v == 1 else 12 if _v == 0 else 13), 1
        _SIGN_CTX[(_h, _v)] = c
        _SIGN_XOR[(_h, _v)] = int(x)


def _sig_ctx(h: int, v: int, d: int, band: str) -> int:
    """Significance-coding context from neighbor counts (band-dependent)."""
    if band == "HL":           # transpose role of H and V
        h, v = v, h
    if band != "HH":           # LL, LH, HL (after swap)
        if h == 2:
            return 8
        if h == 1:
            return 7 if v >= 1 else (6 if d >= 1 else 5)
        if v == 2:
            return 4
        if v == 1:
            return 3
        return 2 if d >= 2 else d      # d in {0,1}
    else:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv >= 1 else 6
        if d == 1:
            return 5 if hv >= 2 else (4 if hv == 1 else 3)
        return 2 if hv >= 2 else hv


@dataclass
class CodeblockStream:
    """Encoded code-block: byte stream + per-pass structure."""
    data: bytes
    msbs: int                      # number of magnitude bit-planes coded
    pass_ends: List[int]           # cumulative byte offset after each pass
    pass_dist: List[float]         # distortion (SSE) remaining after pass
    dist0: float                   # distortion with nothing decoded
    shape: Tuple[int, int]
    band: str

    @property
    def num_passes(self) -> int:
        return len(self.pass_ends)


class _State:
    def __init__(self, h: int, w: int):
        self.sig = np.zeros((h, w), bool)        # significant
        self.visited = np.zeros((h, w), bool)    # coded in current plane
        self.refined = np.zeros((h, w), bool)    # had >=1 refinement
        self.sign = np.zeros((h, w), np.int8)    # 0 = +, 1 = -


def _neighbor_counts(st: _State, y: int, x: int) -> Tuple[int, int, int]:
    h_, w_ = st.sig.shape
    def s(yy, xx):
        return 1 if 0 <= yy < h_ and 0 <= xx < w_ and st.sig[yy, xx] else 0
    h = s(y, x - 1) + s(y, x + 1)
    v = s(y - 1, x) + s(y + 1, x)
    d = s(y - 1, x - 1) + s(y - 1, x + 1) + s(y + 1, x - 1) + s(y + 1, x + 1)
    return h, v, d


def _sign_neighborhood(st: _State, y: int, x: int) -> Tuple[int, int]:
    h_, w_ = st.sig.shape
    def contrib(yy, xx):
        if 0 <= yy < h_ and 0 <= xx < w_ and st.sig[yy, xx]:
            return -1 if st.sign[yy, xx] else 1
        return 0
    h = max(-1, min(1, contrib(y, x - 1) + contrib(y, x + 1)))
    v = max(-1, min(1, contrib(y - 1, x) + contrib(y + 1, x)))
    return h, v


def _scan_columns(h: int, w: int):
    """Stripe scan: yields (stripe_y0, x, rows_in_stripe)."""
    for y0 in range(0, h, 4):
        rows = min(4, h - y0)
        for x in range(w):
            yield y0, x, rows


def _distortion(mag: np.ndarray, sig: np.ndarray, plane: int) -> float:
    """SSE between |coeff| and its mid-point reconstruction with bit-planes
    down to ``plane`` known."""
    known = (mag >> plane) << plane
    half = 1 << plane if plane > 0 else 0
    rec = np.where(sig, known + (half >> 1), 0)
    err = mag.astype(np.float64) - rec.astype(np.float64)
    return float(np.sum(err * err))


def encode_codeblock(coeffs: np.ndarray, band: str) -> CodeblockStream:
    """Encode one code-block of signed integer coefficients."""
    coeffs = np.asarray(coeffs, dtype=np.int64)
    h, w = coeffs.shape
    mag = np.abs(coeffs)
    neg = (coeffs < 0).astype(np.int8)
    maxmag = int(mag.max()) if mag.size else 0
    msbs = int(maxmag).bit_length()
    dist0 = float(np.sum(mag.astype(np.float64) ** 2))
    if msbs == 0:
        return CodeblockStream(b"", 0, [], [], dist0, (h, w), band)

    st = _State(h, w)
    enc = MQEncoder()
    pass_ends: List[int] = []
    pass_dist: List[float] = []

    def record_pass(dist):
        pass_ends.append(enc.flush())
        pass_dist.append(dist)

    def code_sign(y, x):
        hs, vs = _sign_neighborhood(st, y, x)
        cx = _SIGN_CTX[(hs, vs)]
        enc.encode(int(neg[y, x]) ^ _SIGN_XOR[(hs, vs)], cx)

    def sig_pass(plane):
        bit = 1 << plane
        for y0, x, rows in _scan_columns(h, w):
            for r in range(rows):
                y = y0 + r
                if st.sig[y, x]:
                    continue
                hh, vv, dd = _neighbor_counts(st, y, x)
                if hh + vv + dd == 0:
                    continue
                cx = _sig_ctx(hh, vv, dd, band)
                b = 1 if (mag[y, x] & bit) else 0
                enc.encode(b, cx)
                if b:
                    st.sig[y, x] = True
                    st.sign[y, x] = neg[y, x]
                    code_sign(y, x)
                st.visited[y, x] = True

    def mag_pass(plane):
        bit = 1 << plane
        for y0, x, rows in _scan_columns(h, w):
            for r in range(rows):
                y = y0 + r
                if not st.sig[y, x] or st.visited[y, x]:
                    continue
                if st.refined[y, x]:
                    cx = 16
                else:
                    hh, vv, dd = _neighbor_counts(st, y, x)
                    cx = 15 if (hh + vv + dd) else 14
                enc.encode(1 if (mag[y, x] & bit) else 0, cx)
                st.refined[y, x] = True
                st.visited[y, x] = True

    def cleanup_pass(plane):
        bit = 1 << plane
        for y0, x, rows in _scan_columns(h, w):
            r = 0
            # run-length mode: full 4-stripe column, nothing visited,
            # nothing significant, all-zero contexts
            if rows == 4 and not any(
                    st.visited[y0 + k, x] or st.sig[y0 + k, x]
                    for k in range(4)) and all(
                    sum(_neighbor_counts(st, y0 + k, x)) == 0
                    for k in range(4)):
                first = next((k for k in range(4)
                              if mag[y0 + k, x] & bit), None)
                if first is None:
                    enc.encode(0, CTX_RUNLENGTH)
                    continue
                enc.encode(1, CTX_RUNLENGTH)
                enc.encode((first >> 1) & 1, CTX_UNIFORM)
                enc.encode(first & 1, CTX_UNIFORM)
                y = y0 + first
                st.sig[y, x] = True
                st.sign[y, x] = neg[y, x]
                code_sign(y, x)
                r = first + 1
            for k in range(r, rows):
                y = y0 + k
                if st.sig[y, x] or st.visited[y, x]:
                    continue
                hh, vv, dd = _neighbor_counts(st, y, x)
                cx = _sig_ctx(hh, vv, dd, band)
                b = 1 if (mag[y, x] & bit) else 0
                enc.encode(b, cx)
                if b:
                    st.sig[y, x] = True
                    st.sign[y, x] = neg[y, x]
                    code_sign(y, x)
        st.visited[:] = False

    # first plane: cleanup only (T.800 D.4)
    cleanup_pass(msbs - 1)
    record_pass(_distortion(mag, st.sig, msbs - 1))
    for plane in range(msbs - 2, -1, -1):
        sig_pass(plane)
        record_pass(_mixed_distortion(mag, st, plane))
        mag_pass(plane)
        record_pass(_mixed_distortion(mag, st, plane))
        cleanup_pass(plane)
        record_pass(_distortion(mag, st.sig, plane))
    return CodeblockStream(enc.get_bytes(), msbs, pass_ends, pass_dist,
                           dist0, (h, w), band)


def _mixed_distortion(mag: np.ndarray, st: _State, plane: int) -> float:
    """Distortion mid-plane: coefficients coded so far in this plane
    (visited) are known to ``plane``; untouched significant ones only to
    ``plane+1``."""
    res_hi = (mag >> (plane + 1)) << (plane + 1)
    res_lo = (mag >> plane) << plane
    half_hi = (1 << (plane + 1)) >> 1
    half_lo = (1 << plane) >> 1
    known_now = st.visited & st.sig
    rec = np.where(st.sig,
                   np.where(known_now, res_lo + half_lo, res_hi + half_hi),
                   0)
    err = mag.astype(np.float64) - rec.astype(np.float64)
    return float(np.sum(err * err))


def decode_codeblock(stream_data: bytes, msbs: int, num_passes: int,
                     shape: Tuple[int, int], band: str,
                     pass_ends: Optional[List[int]] = None) -> np.ndarray:
    """Decode (possibly truncated) code-block data.

    ``num_passes`` may be smaller than the encoded count (layer truncation).
    ``pass_ends`` gives each pass's segment end offset; required because
    passes are individually terminated.
    """
    h, w = shape
    out_mag = np.zeros((h, w), np.int64)
    st = _State(h, w)
    if msbs == 0 or num_passes == 0:
        return out_mag
    dec = MQDecoder(stream_data)
    ends = pass_ends or [len(stream_data)]

    def seg(i):
        s = 0 if i == 0 else ends[i - 1]
        e = ends[i] if i < len(ends) else len(stream_data)
        dec.start_segment(s, e)

    def decode_sign(y, x):
        hs, vs = _sign_neighborhood(st, y, x)
        cx = _SIGN_CTX[(hs, vs)]
        return dec.decode(cx) ^ _SIGN_XOR[(hs, vs)]

    pass_idx = 0

    def sig_pass(plane):
        bit = 1 << plane
        for y0, x, rows in _scan_columns(h, w):
            for r in range(rows):
                y = y0 + r
                if st.sig[y, x]:
                    continue
                hh, vv, dd = _neighbor_counts(st, y, x)
                if hh + vv + dd == 0:
                    continue
                cx = _sig_ctx(hh, vv, dd, band)
                if dec.decode(cx):
                    st.sig[y, x] = True
                    out_mag[y, x] |= bit
                    st.sign[y, x] = decode_sign(y, x)
                st.visited[y, x] = True

    def mag_pass(plane):
        bit = 1 << plane
        for y0, x, rows in _scan_columns(h, w):
            for r in range(rows):
                y = y0 + r
                if not st.sig[y, x] or st.visited[y, x]:
                    continue
                if st.refined[y, x]:
                    cx = 16
                else:
                    hh, vv, dd = _neighbor_counts(st, y, x)
                    cx = 15 if (hh + vv + dd) else 14
                if dec.decode(cx):
                    out_mag[y, x] |= bit
                else:
                    out_mag[y, x] &= ~bit
                st.refined[y, x] = True
                st.visited[y, x] = True

    def cleanup_pass(plane):
        bit = 1 << plane
        for y0, x, rows in _scan_columns(h, w):
            r = 0
            if rows == 4 and not any(
                    st.visited[y0 + k, x] or st.sig[y0 + k, x]
                    for k in range(4)) and all(
                    sum(_neighbor_counts(st, y0 + k, x)) == 0
                    for k in range(4)):
                if not dec.decode(CTX_RUNLENGTH):
                    continue
                first = (dec.decode(CTX_UNIFORM) << 1) | dec.decode(CTX_UNIFORM)
                y = y0 + first
                st.sig[y, x] = True
                out_mag[y, x] |= bit
                st.sign[y, x] = decode_sign(y, x)
                r = first + 1
            for k in range(r, rows):
                y = y0 + k
                if st.sig[y, x] or st.visited[y, x]:
                    continue
                hh, vv, dd = _neighbor_counts(st, y, x)
                cx = _sig_ctx(hh, vv, dd, band)
                if dec.decode(cx):
                    st.sig[y, x] = True
                    out_mag[y, x] |= bit
                    st.sign[y, x] = decode_sign(y, x)
        st.visited[:] = False

    seg(0)
    cleanup_pass(msbs - 1)
    pass_idx = 1
    plane = msbs - 1
    stopped_after_spp_only = False
    p = msbs - 2
    while p >= 0 and pass_idx < num_passes:
        seg(pass_idx)
        sig_pass(p)
        pass_idx += 1
        plane = p
        if pass_idx >= num_passes:
            stopped_after_spp_only = True
            break
        seg(pass_idx)
        mag_pass(p)
        pass_idx += 1
        if pass_idx >= num_passes:
            break
        seg(pass_idx)
        cleanup_pass(p)
        pass_idx += 1
        p -= 1

    # mid-point reconstruction of the uncoded planes (r = 1/2 rule): each
    # significant coefficient knows its bits down to plane ``u``; add half
    # of the remaining uncertainty interval.
    if stopped_after_spp_only:
        u = np.where(st.visited, plane, plane + 1)
    else:
        u = np.full((h, w), plane, np.int64)
    half = np.where((u > 0) & st.sig, (np.int64(1) << np.maximum(u, 1)) >> 1, 0)
    rec = out_mag + half
    signs = np.where(st.sign.astype(bool), -1, 1)
    return rec * signs
