"""Standard JPEG 2000 code-stream export (ITU-T T.800 interop).

Copy of ``qsvc_tpu/codec/j2k.py`` (numpy host code; the same bytes for
the same input).  The framework's own container (:mod:`.codestream`)
deviates from J2K Tier-2 by design; this module provides the spec-compatible bridge the
reference implicitly had through Kakadu: one grayscale component plane ->
one raw ``.j2c`` code-stream (SOC/SIZ/COD/QCD/SOT/SOD + LRCP packets +
EOC) that ANY conformant decoder reads — the reference codes Y/U/V as
separate grayscale code-streams exactly like this
(texture_compress_fb_j2k.py:154-196).

Contents:

* the standard reversible 5/3 with symmetric extension and the +2 update
  rounding (T.800 F.4.8.2) — deliberately distinct from
  :mod:`..ops.lifting`, which reproduces the reference C++'s truncating
  variant bit-exactly;
* EBCOT Tier-1 via the framework's own MQ coder (the native coder of
  :mod:`.fast`), every pass terminated (code-block style TERMALL, which
  the COD marker signals);
* Tier-2: tag-tree coded packet headers (inclusion, zero bit-planes,
  pass counts, Lblock length signalling) with 0xFF bit-stuffing, single
  quality layer, full-tile precincts, LRCP progression.

The interop test decodes these streams with OpenJPEG (via Pillow) and
asserts bit-exact lossless round trips — external conformance evidence
for the whole MQ + Tier-1 + Tier-2 stack, including the guarded flush.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Tuple

import numpy as np

from . import fast

GUARD_BITS = 2


# ------------------------------------------------------------ 5/3 (T.800)

def _fwd53_1d(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """T.800 F.4.8.2 forward 5/3 along the last axis with symmetric
    extension; returns (low, high) with len(low) = ceil(n/2)."""
    n = a.shape[-1]
    if n == 1:
        return a.copy(), a[..., :0]
    even = a[..., 0::2].astype(np.int32)
    odd = a[..., 1::2].astype(np.int32)
    ne, no = even.shape[-1], odd.shape[-1]
    if ne == no:          # even n: odd[last] needs x[n] -> reflect x[n-2]
        ev_l = even
        ev_r = np.concatenate([even[..., 1:], even[..., -1:]], -1)
    else:                 # odd n: even has one extra sample
        ev_l = even[..., :-1]
        ev_r = even[..., 1:]
    d = odd - (ev_l + ev_r) // 2
    if ne == no:
        d_left = np.concatenate([d[..., :1], d[..., :-1]], -1)
        d_right = d
    else:                 # even[last] needs d[ne-1] -> reflect d[no-1]
        d_left = np.concatenate([d[..., :1], d], -1)
        d_right = np.concatenate([d, d[..., -1:]], -1)
    s = even + (d_left + d_right + 2) // 4
    return s, d


def fwd_dwt53(img: np.ndarray, levels: int) -> np.ndarray:
    """Packed multi-level forward 5/3 (standard variant): per level the
    VERTICAL pass runs first, then the horizontal (T.800 F.4.2 order —
    verified bit-exact against OpenJPEG's inverse; the reference's own
    dwt2d.cpp uses rows-first, another documented difference between the
    two 5/3 variants)."""
    x = img.astype(np.int32).copy()
    H, W = x.shape
    h, w = H, W
    for _ in range(levels):
        sub = x[:h, :w]
        lo, hi = _fwd53_1d(np.swapaxes(sub, 0, 1))   # columns
        sub = np.swapaxes(np.concatenate([lo, hi], axis=-1), 0, 1)
        lo, hi = _fwd53_1d(sub)                      # rows
        sub = np.concatenate([lo, hi], axis=-1)
        x[:h, :w] = sub
        h, w = (h + 1) // 2, (w + 1) // 2
    return x


def inv_dwt53(packed: np.ndarray, levels: int) -> np.ndarray:
    """Inverse of :func:`fwd_dwt53` (used by tests / our-side decode)."""
    x = packed.astype(np.int32).copy()
    H, W = x.shape
    dims = [(H, W)]
    for _ in range(levels):
        H, W = (H + 1) // 2, (W + 1) // 2
        dims.append((H, W))
    for lv in range(levels, 0, -1):
        h, w = dims[lv - 1]
        sub = x[:h, :w]
        sub = _inv53_1d(sub, (w + 1) // 2)           # rows
        sub = np.swapaxes(_inv53_1d(np.swapaxes(sub, 0, 1),
                                    (h + 1) // 2), 0, 1)
        x[:h, :w] = sub
    return x


def _inv53_1d(a: np.ndarray, nl: int) -> np.ndarray:
    n = a.shape[-1]
    if n == 1:
        return a.copy()
    s = a[..., :nl].astype(np.int32)
    d = a[..., nl:].astype(np.int32)
    ne, no = s.shape[-1], d.shape[-1]
    if ne == no:
        d_left = np.concatenate([d[..., :1], d[..., :-1]], -1)
        d_right = d
    else:
        d_left = np.concatenate([d[..., :1], d], -1)
        d_right = np.concatenate([d, d[..., -1:]], -1)
    even = s - (d_left + d_right + 2) // 4
    if ne == no:
        ev_l = even
        ev_r = np.concatenate([even[..., 1:], even[..., -1:]], -1)
    else:
        ev_l = even[..., :-1]
        ev_r = even[..., 1:]
    odd = d + (ev_l + ev_r) // 2
    out = np.empty(a.shape[:-1] + (n,), np.int32)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


# ------------------------------------------------------------ 9/7 (T.800)

#: T.800 F.4.8.2 irreversible 9/7 lifting constants
_A97 = -1.586134342059924
_B97 = -0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971
_K97 = 1.230174104914001


def _fwd97_1d(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """T.800 forward 9/7 along the last axis, symmetric (whole-sample)
    extension.  Returns (low, high); low scaled by 1/K, high by K —
    the convention OpenJPEG's inverse expects (verified by the lossy
    interop test decoding our streams)."""
    n = a.shape[-1]
    if n == 1:
        return a.astype(np.float64).copy(), a[..., :0].astype(np.float64)
    x = a.astype(np.float64)
    even = x[..., 0::2]
    odd = x[..., 1::2]
    ne, no = even.shape[-1], odd.shape[-1]

    def pair_e(ev):       # e_i + e_{i+1} aligned with each odd sample
        if ne == no:
            return ev + np.concatenate([ev[..., 1:], ev[..., -1:]], -1)
        return ev[..., :-1] + ev[..., 1:]

    def pair_d(d):        # d_{i-1} + d_i aligned with each even sample
        if ne == no:
            return np.concatenate([d[..., :1], d[..., :-1]], -1) + d
        return (np.concatenate([d[..., :1], d], -1)
                + np.concatenate([d, d[..., -1:]], -1))

    d = odd + _A97 * pair_e(even)
    s = even + _B97 * pair_d(d)
    d = d + _G97 * pair_e(s)
    s = s + _D97 * pair_d(d)
    return s * (1.0 / _K97), d * _K97


def fwd_dwt97(img: np.ndarray, levels: int) -> np.ndarray:
    """Packed multi-level forward irreversible 9/7 (vertical pass first,
    like :func:`fwd_dwt53`)."""
    x = img.astype(np.float64).copy()
    H, W = x.shape
    h, w = H, W
    for _ in range(levels):
        sub = x[:h, :w]
        lo, hi = _fwd97_1d(np.swapaxes(sub, 0, 1))   # columns
        sub = np.swapaxes(np.concatenate([lo, hi], axis=-1), 0, 1)
        lo, hi = _fwd97_1d(sub)                      # rows
        sub = np.concatenate([lo, hi], axis=-1)
        x[:h, :w] = sub
        h, w = (h + 1) // 2, (w + 1) // 2
    return x


def _inv97_1d(a: np.ndarray, nl: int) -> np.ndarray:
    n = a.shape[-1]
    if n == 1:
        return a.astype(np.float64).copy()
    s = a[..., :nl].astype(np.float64) * _K97
    d = a[..., nl:].astype(np.float64) * (1.0 / _K97)
    ne, no = s.shape[-1], d.shape[-1]

    def pair_d(dd):
        if ne == no:
            return np.concatenate([dd[..., :1], dd[..., :-1]], -1) + dd
        return (np.concatenate([dd[..., :1], dd], -1)
                + np.concatenate([dd, dd[..., -1:]], -1))

    def pair_e(ev):
        if ne == no:
            return ev + np.concatenate([ev[..., 1:], ev[..., -1:]], -1)
        return ev[..., :-1] + ev[..., 1:]

    s = s - _D97 * pair_d(d)
    d = d - _G97 * pair_e(s)
    s = s - _B97 * pair_d(d)
    d = d - _A97 * pair_e(s)
    out = np.empty(a.shape[:-1] + (n,), np.float64)
    out[..., 0::2] = s
    out[..., 1::2] = d
    return out


def inv_dwt97(packed: np.ndarray, levels: int) -> np.ndarray:
    """Inverse of :func:`fwd_dwt97` (the oracle for the lossy interop
    test: OpenJPEG's decode of our stream must match this reconstruction
    of the dequantized coefficients)."""
    x = packed.astype(np.float64).copy()
    H, W = x.shape
    dims = [(H, W)]
    for _ in range(levels):
        H, W = (H + 1) // 2, (W + 1) // 2
        dims.append((H, W))
    for lv in range(levels, 0, -1):
        h, w = dims[lv - 1]
        sub = x[:h, :w]
        sub = _inv97_1d(sub, (w + 1) // 2)           # rows
        sub = np.swapaxes(_inv97_1d(np.swapaxes(sub, 0, 1),
                                    (h + 1) // 2), 0, 1)
        x[:h, :w] = sub
    return x


def _qcd_step(delta: float, R_b: int) -> Tuple[int, int, float]:
    """(epsilon, mu, representable step) for one subband: T.800 E.1
    ``delta = 2^(R_b - eps) * (1 + mu/2^11)``.  Quantization uses the
    REPRESENTABLE step so encoder and any conformant decoder agree
    exactly."""
    t = delta / (1 << R_b)
    eps = 0
    while t * (1 << eps) < 1.0 and eps < 31:    # mantissa factor in [1,2)
        eps += 1
    f = t * (1 << eps)
    mu = max(0, min(2047, int(round((f - 1.0) * 2048))))
    rep = (1 << R_b) * (1.0 / (1 << eps)) * (1 + mu / 2048.0)
    return eps, mu, rep


# ------------------------------------------------------------ bit writer

class _BitWriter:
    """Packet-header bit writer with T.800 B.10.1 0xFF bit-stuffing."""

    def __init__(self):
        self.bytes = bytearray()
        self.bits = 0
        self.nbits = 0

    def put(self, bit: int) -> None:
        limit = 7 if (self.bytes and self.bytes[-1] == 0xFF) else 8
        self.bits = (self.bits << 1) | (bit & 1)
        self.nbits += 1
        if self.nbits == limit:
            self.bytes.append(self.bits)
            self.bits = 0
            self.nbits = 0

    def put_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1)

    def flush(self) -> bytes:
        if self.nbits:
            limit = 7 if (self.bytes and self.bytes[-1] == 0xFF) else 8
            self.bytes.append(self.bits << (limit - self.nbits))
            self.bits = 0
            self.nbits = 0
        if self.bytes and self.bytes[-1] == 0xFF:
            self.bytes.append(0x00)
        return bytes(self.bytes)


class _TagTree:
    """T.800 B.10.2 tag tree (encoder side)."""

    def __init__(self, w: int, h: int):
        self.dims = []
        ww, hh = w, h
        while True:
            self.dims.append((ww, hh))
            if ww == 1 and hh == 1:
                break
            ww, hh = (ww + 1) // 2, (hh + 1) // 2
        self.value = [np.full((h_, w_), 1 << 30, np.int64)
                      for (w_, h_) in self.dims]
        self.low = [np.zeros((h_, w_), np.int64) for (w_, h_) in self.dims]
        self.known = [np.zeros((h_, w_), bool) for (w_, h_) in self.dims]

    def set(self, x: int, y: int, v: int) -> None:
        self.value[0][y, x] = v
        # propagate min up
        for lv in range(1, len(self.dims)):
            x, y = x // 2, y // 2
            if v < self.value[lv][y, x]:
                self.value[lv][y, x] = v
            else:
                break

    def encode(self, bw: _BitWriter, x: int, y: int, threshold: int) -> None:
        path = []
        xx, yy = x, y
        for lv in range(len(self.dims)):
            path.append((lv, xx, yy))
            xx, yy = xx // 2, yy // 2
        low = 0
        for (lv, xx, yy) in reversed(path):
            if low > self.low[lv][yy, xx]:
                self.low[lv][yy, xx] = low
            else:
                low = int(self.low[lv][yy, xx])
            while low < threshold:
                if low >= self.value[lv][yy, xx]:
                    if not self.known[lv][yy, xx]:
                        bw.put(1)
                        self.known[lv][yy, xx] = True
                    break
                bw.put(0)
                low += 1
            self.low[lv][yy, xx] = low


def _npasses_code(bw: _BitWriter, n: int) -> None:
    """T.800 Table B.4 number-of-coding-passes codeword."""
    if n == 1:
        bw.put(0)
    elif n == 2:
        bw.put_bits(0b10, 2)
    elif n <= 5:
        bw.put_bits(0b11, 2)
        bw.put_bits(n - 3, 2)
    elif n <= 36:
        bw.put_bits(0b1111, 4)
        bw.put_bits(n - 6, 5)
    else:
        bw.put_bits(0b111111111, 9)
        bw.put_bits(n - 37, 7)


# ------------------------------------------------------------ code-stream

def _band_rects(H: int, W: int, levels: int):
    """Per J2K resolution: list of (band_name, y0, x0, h, w) rectangles in
    the packed layout.  Resolution 0 = LL_levels; resolution r>=1 adds the
    {HL, LH, HH} bands of DWT level (levels - r + 1)."""
    hs = [H]
    ws = [W]
    for _ in range(levels):
        hs.append((hs[-1] + 1) // 2)
        ws.append((ws[-1] + 1) // 2)
    out = [[("LL", 0, 0, hs[levels], ws[levels])]]
    for r in range(1, levels + 1):
        lv = levels - r + 1            # DWT level of these bands
        hl, wl = hs[lv], ws[lv]        # low sizes at this level
        hp, wp = hs[lv - 1], ws[lv - 1]
        out.append([
            ("HL", 0, wl, hl, wp - wl),          # horizontal high
            ("LH", hl, 0, hp - hl, wl),
            ("HH", hl, wl, hp - hl, wp - wl),
        ])
    return out


_BAND_GAIN_LOG2 = {"LL": 0, "HL": 1, "LH": 1, "HH": 2}


def _layer_of_passes(cs, weight: float, thresholds: List[float]
                     ) -> List[int]:
    """Map each coding pass to its quality layer (first layer whose slope
    threshold it reaches; thresholds descending).  Passes below the last
    threshold are DROPPED (the -slope rate control).  Hull slopes are
    non-increasing, so layers are non-decreasing."""
    from .frame_codec import _hull_slopes
    slopes = _hull_slopes(cs.pass_ends, cs.pass_dist, cs.dist0, weight)
    L = len(thresholds)
    out = []
    for s in slopes:
        lay = None
        for l, t in enumerate(thresholds):
            if s >= t:
                lay = l
                break
        out.append(lay if lay is not None else -1)      # -1 = dropped
    # enforce monotone non-decreasing up to the first drop
    keep = len(out)
    for p in range(len(out)):
        if out[p] < 0:
            keep = p
            break
        if p and out[p] < out[p - 1]:
            out[p] = out[p - 1]
    return out[:keep]


def encode_j2c(img: np.ndarray, levels: int = 3, cb: int = 64,
               reversible: bool = True, base_delta: float = 1.0 / 32,
               layer_slopes=None) -> bytes:
    """Encode one grayscale uint8 plane to a standard ``.j2c`` code-stream
    (single tile, LRCP, TERMALL).

    ``reversible=True``: lossless 5/3, no quantization (QCD style 0).
    ``reversible=False``: irreversible 9/7 + scalar-expounded QCD
    (style 2); per-band step = ``base_delta / sqrt(band synthesis
    gain)`` so truncation error is spent evenly in the pixel domain —
    the role of Kakadu's ``Creversible=no -slope``
    (texture_compress_fb_j2k.py:186-196).

    ``layer_slopes``: optional list of quality-layer slopes in the
    reference's Kakadu-style units (texture_compress.py:45 range
    42000-46000, larger = coarser).  Each coding pass lands in the first
    layer whose slope threshold its R-D hull slope reaches; passes below
    the last layer's threshold are dropped (rate control).  None = one
    layer, everything kept."""
    img = np.asarray(img)
    assert img.dtype == np.uint8 and img.ndim == 2
    from . import subbands
    from .frame_codec import slope_to_threshold
    H, W = img.shape

    if layer_slopes:
        thresholds = sorted((slope_to_threshold(float(u))
                             for u in layer_slopes), reverse=True)
    else:
        thresholds = [0.0]
    nlayers = len(thresholds)

    if reversible:
        packed = fwd_dwt53(img.astype(np.int32) - 128, levels)
    else:
        coefs = fwd_dwt97(img.astype(np.float64) - 128.0, levels)

    # --- per-band quantization steps (irreversible)
    rects = _band_rects(H, W, levels)
    band_q: Dict[Tuple[int, str], Tuple[int, int, float]] = {}
    if not reversible:
        for r, bands in enumerate(rects):
            lv = levels - r + 1 if r else levels
            for (band, *_rest) in bands:
                g = subbands.band_gain(band, lv, False)
                delta = base_delta / math.sqrt(g)
                R_b = 8 + _BAND_GAIN_LOG2[band]
                band_q[(r, band)] = _qcd_step(delta, R_b)

    # --- Tier-1 over every band's code-blocks
    res_blocks: List[List[Tuple]] = []   # per res: (band, grid, blocks)
    band_maxbits: Dict[Tuple[int, str], int] = {}
    for r, bands in enumerate(rects):
        entry = []
        lv = levels - r + 1 if r else levels
        for (band, y0, x0, bh, bw_) in bands:
            if bh <= 0 or bw_ <= 0:
                entry.append((band, (0, 0), [], 1.0))
                continue
            if reversible:
                qband = packed[y0:y0 + bh, x0:x0 + bw_]
                weight = subbands.band_gain(band, lv, True)
            else:
                eps, mu, rep = band_q[(r, band)]
                cband = coefs[y0:y0 + bh, x0:x0 + bw_]
                qband = (np.sign(cband)
                         * np.floor(np.abs(cband) / rep)).astype(np.int64)
                mb_cap = GUARD_BITS + eps - 1
                np.clip(qband, -(1 << mb_cap) + 1, (1 << mb_cap) - 1,
                        out=qband)
                weight = subbands.band_gain(band, lv, False) * rep * rep
            gby = -(-bh // cb)
            gbx = -(-bw_ // cb)
            blocks = []
            for by in range(gby):
                for bx in range(gbx):
                    ty, tx = by * cb, bx * cb
                    th = min(cb, bh - ty)
                    tw = min(cb, bw_ - tx)
                    tile = qband[ty:ty + th, tx:tx + tw]
                    cs = fast.encode_codeblock(
                        np.ascontiguousarray(tile, np.int64), band)
                    blocks.append(cs)
                    key = (r, band)
                    band_maxbits[key] = max(band_maxbits.get(key, 1),
                                            cs.msbs)
            entry.append((band, (gby, gbx), blocks, weight))
        res_blocks.append(entry)

    # --- markers
    out = bytearray()
    out += b"\xFF\x4F"                                   # SOC
    out += b"\xFF\x51" + struct.pack(                    # SIZ
        ">HHIIIIIIIIH", 41, 0, W, H, 0, 0, W, H, 0, 0, 1)
    out += struct.pack(">BBB", 7, 1, 1)                  # Ssiz=8u, 1x1
    # COD: Scod=0, LRCP, nlayers, no MCT, levels, cb exponents, TERMALL,
    # transform (1 = reversible 5/3, 0 = irreversible 9/7)
    cbexp = int(math.log2(cb)) - 2
    out += b"\xFF\x52" + struct.pack(">HBBHBBBBBB", 12, 0, 0, nlayers, 0,
                                     levels, cbexp, cbexp, 0x04,
                                     1 if reversible else 0)
    nbands = 3 * levels + 1
    order = [(0, "LL")] + [(r, b) for r in range(1, levels + 1)
                           for b in ("HL", "LH", "HH")]
    if reversible:
        # QCD style 0: per-subband exponents only
        sqcd = GUARD_BITS << 5
        exps = bytearray()
        for key in order:
            mb = band_maxbits.get(key, 1)
            eps = max(mb - GUARD_BITS + 1, 0)
            exps.append(min(eps, 31) << 3)
            band_maxbits[key] = eps + GUARD_BITS - 1     # Mb actually used
        out += b"\xFF\x5C" + struct.pack(">HB", 3 + nbands, sqcd) + exps
    else:
        # QCD style 2 (scalar expounded): 16-bit (eps, mu) per subband
        sqcd = (GUARD_BITS << 5) | 2
        spq = bytearray()
        for key in order:
            eps, mu, _rep = band_q.get(key, (0, 0, 1.0))
            spq += struct.pack(">H", (eps << 11) | mu)
            band_maxbits[key] = GUARD_BITS + eps - 1     # T.800 E.1 Mb
        out += b"\xFF\x5C" + struct.pack(">HB", 3 + 2 * nbands, sqcd) + spq

    # --- pass -> layer assignment (layer_slopes also truncates: passes
    # below the last layer's threshold are never emitted)
    layer_maps: Dict[Tuple[int, int], List[int]] = {}   # (res, blockid)
    for r, entry in enumerate(res_blocks):
        bid = 0
        for (band, (gby, gbx), blocks, weight) in entry:
            for cs in blocks:
                layer_maps[(r, bid)] = (
                    [0] * cs.num_passes if layer_slopes is None
                    else _layer_of_passes(cs, weight, thresholds))
                bid += 1

    # --- packets (LRCP: for each layer, res 0..levels)
    body = bytearray()
    state: Dict[Tuple[int, int], Dict] = {}             # per (res, blockid)
    for r, entry in enumerate(res_blocks):
        bid = 0
        for (band, (gby, gbx), blocks, weight) in entry:
            for cs in blocks:
                lm = layer_maps[(r, bid)]
                state[(r, bid)] = {"included": False, "lblock": 3,
                                   "sent": 0, "first": lm[0] if lm else
                                   (1 << 20), "lm": lm}
                bid += 1

    for lay in range(nlayers):
        for r, entry in enumerate(res_blocks):
            bw = _BitWriter()
            datas: List[bytes] = []
            # does anything contribute? (empty packet = single 0 bit)
            bid0 = 0
            any_contrib = False
            for (band, (gby, gbx), blocks, weight) in entry:
                for cs in blocks:
                    st = state[(r, bid0)]
                    n_lay = sum(1 for l in st["lm"] if l == lay)
                    if n_lay:
                        any_contrib = True
                    bid0 += 1
            if not any_contrib and lay > 0:
                bw.put(0)
                body += bw.flush()
                continue
            bw.put(1)
            bid = 0
            for (band, (gby, gbx), blocks, weight) in entry:
                if not blocks:
                    continue
                if lay == 0:
                    inc = _TagTree(gbx, gby)
                    zbp = _TagTree(gbx, gby)
                    mb = band_maxbits[(r, band)]
                    for i, cs in enumerate(blocks):
                        by, bx = divmod(i, gbx)
                        st = state[(r, bid + i)]
                        first = st["first"]
                        inc.set(bx, by, first)
                        zbp.set(bx, by, max(mb - cs.msbs, 0)
                                if first < (1 << 20) else 0)
                    state[(r, bid)]["trees"] = (inc, zbp, mb)
                (inc, zbp, mb) = state[(r, bid)]["trees"]
                for i, cs in enumerate(blocks):
                    by, bx = divmod(i, gbx)
                    st = state[(r, bid + i)]
                    n_lay = sum(1 for l in st["lm"] if l == lay)
                    if not st["included"]:
                        inc.encode(bw, bx, by, lay + 1)
                        if st["first"] > lay:
                            continue
                        st["included"] = True
                        zbp.encode(bw, bx, by, (mb - cs.msbs) + 1)
                    else:
                        bw.put(1 if n_lay else 0)
                        if not n_lay:
                            continue
                    _npasses_code(bw, n_lay)
                    lo = st["sent"]
                    seg_lens = []
                    prev = cs.pass_ends[lo - 1] if lo else 0
                    for e in cs.pass_ends[lo:lo + n_lay]:
                        seg_lens.append(e - prev)
                        prev = e
                    lblock = st["lblock"]
                    need = max(max(L.bit_length(), 1) for L in seg_lens)
                    while lblock < need:
                        bw.put(1)
                        lblock += 1
                    bw.put(0)
                    st["lblock"] = lblock
                    for L in seg_lens:                   # TERMALL: one
                        bw.put_bits(L, lblock)           # length per pass
                    start = cs.pass_ends[lo - 1] if lo else 0
                    datas.append(cs.data[start:cs.pass_ends[lo + n_lay - 1]])
                    st["sent"] = lo + n_lay
                bid += len(blocks)
            body += bw.flush()
            for d in datas:
                body += d

    psot = 12 + 2 + len(body)                            # SOT..EOC-exclusive
    out += b"\xFF\x90" + struct.pack(">HHIBB", 10, 0, psot, 0, 1)
    out += b"\xFF\x93"                                   # SOD
    out += body
    out += b"\xFF\xD9"                                   # EOC
    return bytes(out)
