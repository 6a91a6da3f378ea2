"""The stream writer: a frozen copy of the writing half of
``qsvc_tpu_torch/codec/codestream.py`` (version 5, internal texture
frames only), with the motion fields coded by the spec MQ coder of
:mod:`.tier1` (the program's native MQ coder writes the same bytes)."""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import CodecConfig
from . import tier1
from .texture import Frame, threshold_to_slope

MAGIC = b"QSVC"
VERSION = 5
_CODERS = ["mq", "bp"]
_BANDS = ["LL", "HL", "LH", "HH"]


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


def _slope_u16(s: float) -> int:
    u = threshold_to_slope(s)
    return max(0, min(65535, int(round(u))))


def _band_code(key: str) -> int:
    band = key.rstrip("0123456789")
    level = int(key[len(band):])
    return (level << 2) | _BANDS.index(band)


def _write_frame(out: bytearray, ef: Frame) -> None:
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
        _wvarint(out, len(b.pass_ends))
        prev = 0
        for e, s in zip(b.pass_ends, b.pass_slopes):
            _wvarint(out, e - prev)
            prev = e
            out += struct.pack("<H", _slope_u16(s))
        _wvarint(out, len(b.data))
        out += b.data


def encode_motion_field(field: np.ndarray) -> Dict:
    """A (2, 2, By, Bx) residue field as four lossless code-blocks."""
    parts = []
    for d in range(2):
        for c in range(2):
            cb = tier1.encode_codeblock(
                np.ascontiguousarray(field[d, c].astype(np.int64)), "LL")
            parts.append((cb.data, cb.msbs, list(cb.pass_ends)))
    return {"shape": field.shape[-2:], "parts": parts}


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


def to_bytes(cfg: CodecConfig, reversible: bool, delta: float,
             low: List[Dict[str, Frame]],
             levels: List[Tuple[List[Dict[str, Frame]], List[Dict], bytes]],
             true_dims: Optional[Tuple[int, int]] = None,
             true_frames: Optional[int] = None) -> bytes:
    """The serialized stream: ``levels`` are (high frames, motion, frame
    types) per temporal level, finest first."""
    out = bytearray()
    out += MAGIC
    c = cfg
    out += struct.pack("<BHHBBHBffBHB",
                       VERSION, c.pixels_in_x, c.pixels_in_y, c.TRLs,
                       c.SRLs, c.GOPs, c.auto_block_size,
                       c.update_factor, delta,
                       1 if reversible else 0,
                       c.search_range, c.nLayers)
    out += struct.pack("<BBBf", c.subpixel_accuracy,
                       c.block_overlaping, c.auto_block_size_min, c.FPS)
    tw, th = true_dims or (c.pixels_in_x, c.pixels_in_y)
    _wvarint(out, tw)
    _wvarint(out, th)
    _wvarint(out, true_frames if true_frames is not None else c.pictures)
    _wvarint(out, len(low))
    for fr in low:
        for comp in ("y", "u", "v"):
            _write_frame(out, fr[comp])
    _wvarint(out, len(levels))
    for high, motion, ftypes in levels:
        _wvarint(out, len(high))
        out += ftypes
        for fr in high:
            for comp in ("y", "u", "v"):
                _write_frame(out, fr[comp])
        for m in motion:
            _write_motion(out, m)
    return bytes(out)
