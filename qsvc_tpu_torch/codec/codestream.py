"""Serialized code-stream container for a compressed video.

Replaces the reference's loose-file stream layout (per-frame ``*.j2c``
files + ``.j2c``/``.mjc`` cumulative size indices + ``frame_types_t`` +
``motion_residue_t``, SURVEY.md §1 data plane) with one self-describing
binary stream that preserves the same structure and the same scalability
affordances:

* texture: per temporal subband (H_1 .. H_{T-1}, then L_{T-1}), per frame,
  per component (Y/U/V), an :class:`~.frame_codec.EncodedFrame` whose
  code-block passes carry distortion-length slopes (quantized to the
  reference's slope units) — quality (QS) extraction truncates passes,
  spatial (SS) extraction drops resolution levels, temporal (TS)
  extraction drops whole H sections, all without re-encoding;
* motion: per level, per frame-pair, the decorrelated MV residue fields
  coded losslessly as single EBCOT code-blocks with no DWT — mirroring the
  reference's ``Clevels=0 Creversible=yes`` motion path
  (motion_compress_j2k.py:131-141);
* frame types: one byte ('I'/'B') per pair per level (decorrelate.cpp
  frame_types stream);
* a byte-accounting index is recoverable by walking section sizes (the
  ``info`` metrics use it).

Wire format: little-endian, varint-prefixed sections; see ``_w*``/``_r*``
helpers.  Decoders tolerate truncated/missing texture payloads by
concealing with neutral gray (the reference's resilience behaviour,
texture_expand_fb_j2k.py:169-177).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import CodecConfig
from ..utils import trace
from . import fast, frame_codec
from .frame_codec import EncodedBlock, EncodedFrame, slope_to_threshold, \
    threshold_to_slope

MAGIC = b"QSVC"
#: v2: per-frame entropy-coder id ("mq" | "bp"); v3: sub-pixel accuracy,
#: block overlap, block_size_min and FPS in the header (decode-relevant
#: MC parameters; omitting them mis-decoded byte-serialized streams of
#: those modes); v4: true (pre-padding) geometry + frame count so
#: arbitrary input dims/lengths round-trip (the reference instead
#: REJECTED dims not divisible by block_size and pictures != k*GOP+1,
#: trunk/readme.txt:102-110 — SURVEY §7 lists that as a quirk to fix by
#: padding); v5: per-frame codec tag (0 = internal EncodedFrame, 1 =
#: alternative texture backend, codec/backends.py — the reference's
#: codec-registry capability).  v3/v4 streams still parse.
VERSION = 5

_CODERS = ["mq", "bp"]


# ---------------------------------------------------------------- helpers

def _wvarint(out: bytearray, v: int) -> None:
    if v < 0:
        raise ValueError("varint must be non-negative")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def varint(self) -> int:
        v = 0
        shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                return v
            shift += 7

    def bytes_(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def struct(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return vals


def _slope_u16(s: float) -> int:
    """Quantize a distortion-length slope to reference-style units."""
    u = threshold_to_slope(s)
    return max(0, min(65535, int(round(u))))


# ------------------------------------------------- encoded frame (de)ser

def _write_frame(out: bytearray, ef) -> None:
    from . import backends
    if isinstance(ef, backends.BackendFrame):
        out.append(1)
        backends.write_frame(out, ef, _wvarint)
        return
    out.append(0)
    out += struct.pack("<HHBBf BB", ef.H, ef.W, ef.levels,
                       1 if ef.reversible else 0, ef.delta,
                       min(ef.codeblock_size, 255),
                       _CODERS.index(ef.coder))
    _wvarint(out, len(ef.blocks))
    for b in ef.blocks:
        out += struct.pack("<HHHHB", b.y0, b.x0, b.shape[0], b.shape[1],
                           b.msbs)
        _wvarint(out, _band_code(b.band_key))
        _wvarint(out, b.num_passes)
        prev = 0
        for e, s in zip(b.pass_ends, b.pass_slopes):
            _wvarint(out, e - prev)
            prev = e
            out += struct.pack("<H", _slope_u16(s))
        _wvarint(out, len(b.data))
        out += b.data


_BANDS = ["LL", "HL", "LH", "HH"]


def _band_code(key: str) -> int:
    band = key.rstrip("0123456789")
    level = int(key[len(band):])
    return (level << 2) | _BANDS.index(band)


def _band_key(code: int) -> Tuple[str, int, str]:
    band = _BANDS[code & 3]
    level = code >> 2
    return f"{band}{level}", level, band


def _read_frame(r: _Reader, ver: int = VERSION):
    if ver >= 5:
        tag = r.data[r.pos]
        r.pos += 1
        if tag == 1:
            from . import backends
            return backends.read_frame(r)
    H, W, levels, rev, delta, cbs, coder = r.struct("<HHBBf BB")
    nblocks = r.varint()
    blocks: List[EncodedBlock] = []
    for _ in range(nblocks):
        y0, x0, sh, sw, msbs = r.struct("<HHHHB")
        key, level, band = _band_key(r.varint())
        npasses = r.varint()
        ends: List[int] = []
        slopes: List[float] = []
        prev = 0
        for _ in range(npasses):
            prev += r.varint()
            ends.append(prev)
            (u,) = r.struct("<H")
            slopes.append(slope_to_threshold(u))
        dlen = r.varint()
        data = bytes(r.bytes_(dlen))
        blocks.append(EncodedBlock(key, level, band, y0, x0, (sh, sw),
                                   msbs, data, ends, slopes))
    return EncodedFrame(H, W, levels, bool(rev), delta, cbs, blocks,
                        _CODERS[coder])


# ------------------------------------------------- motion (de)serialization

def encode_motion_fields(fields: List[np.ndarray]) -> List[Dict]:
    """Losslessly code a batch of (2,2,By,Bx) MV residue fields in ONE
    native call (4 code-blocks per field, no DWT — reference Clevels=0
    path).  Batching all of a GOP's fields amortizes the per-call
    marshalling of the native coder, which dominates for these tiny
    blocks."""
    tiles = [np.ascontiguousarray(f[d, c].astype(np.int64))
             for f in fields for d in range(2) for c in range(2)]
    cbs = fast.encode_codeblocks_batch(tiles, ["LL"] * len(tiles))
    out = []
    for i, f in enumerate(fields):
        part = cbs[4 * i:4 * i + 4]
        out.append({"shape": f.shape[-2:],
                    "parts": [(cb.data, cb.msbs, cb.pass_ends)
                              for cb in part]})
    return out


def encode_motion_field(field_arr: np.ndarray) -> Dict:
    """Losslessly code one (2,2,By,Bx) MV residue field: four single
    code-blocks, no DWT (reference Clevels=0 path)."""
    return encode_motion_fields([field_arr])[0]


def decode_motion_field(enc: Dict) -> np.ndarray:
    By, Bx = enc["shape"]
    blocks = [(data, msbs, len(ends), (By, Bx), "LL", ends)
              for (data, msbs, ends) in enc["parts"]]
    tiles = fast.decode_codeblocks_batch(blocks)
    out = np.zeros((2, 2, By, Bx), np.int64)
    k = 0
    for d in range(2):
        for c in range(2):
            out[d, c] = tiles[k]
            k += 1
    return out.astype(np.int32)


def _write_motion(out: bytearray, enc: Dict) -> None:
    By, Bx = enc["shape"]
    out += struct.pack("<HH", By, Bx)
    for data, msbs, ends in enc["parts"]:
        out.append(msbs)
        _wvarint(out, len(ends))
        prev = 0
        for e in ends:
            _wvarint(out, e - prev)
            prev = e
        _wvarint(out, len(data))
        out += data


def _read_motion(r: _Reader) -> Dict:
    By, Bx = r.struct("<HH")
    parts = []
    for _ in range(4):
        msbs = r.data[r.pos]
        r.pos += 1
        n = r.varint()
        ends = []
        prev = 0
        for _ in range(n):
            prev += r.varint()
            ends.append(prev)
        dlen = r.varint()
        parts.append((bytes(r.bytes_(dlen)), msbs, ends))
    return {"shape": (By, Bx), "parts": parts}


# ------------------------------------------------- multi-GOP container

GOP_MAGIC = b"QSVG"


def pack_gop_streams(streams: List[bytes]) -> bytes:
    """Frame an ordered list of per-GOP streams into one file: the
    streaming CLI writes GOPs as they finish (each is a self-contained
    :class:`VideoStream`, the analogue of the reference's per-GOP file
    drops, transcode.py:2102-2127).

    The format is append-only (magic + repeated length-prefixed payloads,
    no upfront count): a streaming writer emits each GOP as it finishes
    and a killed encode leaves a decodable prefix."""
    out = bytearray()
    out += GOP_MAGIC
    for s in streams:
        _wvarint(out, len(s))
        out += s
    return bytes(out)


def unpack_gop_streams(data: bytes) -> List[bytes]:
    if data[:4] != GOP_MAGIC:
        raise ValueError("not a QSVC GOP container")
    r = _Reader(data, 4)
    out = []
    while r.pos < len(data):
        out.append(bytes(r.bytes_(r.varint())))
    return out


def is_gop_container(data: bytes) -> bool:
    return data[:4] == GOP_MAGIC


# ------------------------------------------------------- top-level stream

@dataclass
class LevelSection:
    """Encoded data of one temporal level."""
    high: List[Dict[str, EncodedFrame]]     # per frame: {"y","u","v"}
    motion: List[Dict]                      # per frame: encoded MV residue
    frame_types: bytes                      # b"I"/b"B" per frame


@dataclass
class VideoStream:
    cfg: CodecConfig
    reversible: bool
    delta: float
    low: List[Dict[str, EncodedFrame]]      # final L band frames
    levels: List[LevelSection]              # level 1 (finest) .. T-1
    #: true (pre-padding) geometry (width, height) and frame count; None
    #: when the coded geometry IS the true geometry (no padding applied)
    true_dims: Optional[Tuple[int, int]] = None
    true_frames: Optional[int] = None

    # ------------------------------------------------------------ sizes

    def texture_bytes(self) -> Dict[str, int]:
        out = {}
        out["L"] = sum(f.total_bytes for fr in self.low
                       for f in fr.values())
        for i, lev in enumerate(self.levels):
            out[f"H{i+1}"] = sum(f.total_bytes for fr in lev.high
                                 for f in fr.values())
        return out

    def motion_bytes(self) -> Dict[str, int]:
        out = {}
        for i, lev in enumerate(self.levels):
            out[f"M{i+1}"] = sum(
                sum(len(d) for d, _, _ in m["parts"]) for m in lev.motion)
        return out

    # ------------------------------------------------------- serialization

    def to_bytes(self) -> bytes:
        with trace.stage("stream.serialize"):
            out = bytearray()
            out += MAGIC
            c = self.cfg
            out += struct.pack("<BHHBBHBffBHB",
                               VERSION, c.pixels_in_x, c.pixels_in_y, c.TRLs,
                               c.SRLs, c.GOPs, c.auto_block_size,
                               c.update_factor, self.delta,
                               1 if self.reversible else 0,
                               c.search_range, c.nLayers)
            out += struct.pack("<BBBf", c.subpixel_accuracy,
                               c.block_overlaping, c.auto_block_size_min,
                               c.FPS)
            tw, th = self.true_dims or (c.pixels_in_x, c.pixels_in_y)
            _wvarint(out, tw)
            _wvarint(out, th)
            _wvarint(out, self.true_frames
                     if self.true_frames is not None else c.pictures)
            _wvarint(out, len(self.low))
            for fr in self.low:
                for comp in ("y", "u", "v"):
                    _write_frame(out, fr[comp])
            _wvarint(out, len(self.levels))
            for lev in self.levels:
                _wvarint(out, len(lev.high))
                out += lev.frame_types
                for fr in lev.high:
                    for comp in ("y", "u", "v"):
                        _write_frame(out, fr[comp])
                for m in lev.motion:
                    _write_motion(out, m)
            return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "VideoStream":
        if data[:4] != MAGIC:
            raise ValueError("not a QSVC stream")
        r = _Reader(data, 4)
        (ver, px, py, trls, srls, gops, bs, uf, delta, rev, sr,
         nlayers) = r.struct("<BHHBBHBffBHB")
        if ver not in (3, 4, VERSION):
            raise ValueError(f"unsupported stream version {ver}")
        subpix, overlap, bsmin, fps = r.struct("<BBBf")
        cfg = CodecConfig(pixels_in_x=px, pixels_in_y=py, TRLs=trls,
                          SRLs=srls, GOPs=gops, block_size=bs,
                          block_size_min=bsmin, update_factor=uf,
                          search_range=sr, nLayers=nlayers,
                          subpixel_accuracy=subpix,
                          block_overlaping=overlap, FPS=fps)
        true_dims = None
        true_frames = None
        if ver >= 4:
            tw, th, tf = r.varint(), r.varint(), r.varint()
            if (tw, th) != (px, py):
                true_dims = (tw, th)
            if tf != cfg.pictures:
                true_frames = tf
        nlow = r.varint()
        low = []
        for _ in range(nlow):
            low.append({comp: _read_frame(r, ver) for comp in ("y", "u", "v")})
        nlev = r.varint()
        levels = []
        for _ in range(nlev):
            nframes = r.varint()
            ftypes = bytes(r.bytes_(nframes))
            high = []
            for _ in range(nframes):
                high.append({comp: _read_frame(r, ver)
                             for comp in ("y", "u", "v")})
            motion = [_read_motion(r) for _ in range(nframes)]
            levels.append(LevelSection(high, motion, ftypes))
        return cls(cfg, bool(rev), delta, low, levels,
                   true_dims=true_dims, true_frames=true_frames)
