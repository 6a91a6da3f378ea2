"""The stream reader: the inverse of :mod:`.container`'s writer, split
into what a stream must hold exactly and what it may code differently.

* ``layout``: everything that is not a texture block's coded passes:
  the stream and frame headers, each block's place and band, the frame
  types and the motion sections whole (motion is integer: its bytes are
  exact);
* ``frames``: per texture frame and component, in stream order, each
  block's coded passes as (msbs, pass lengths in bytes, data, (th, tw)),
  the input of :func:`.bp.decode_blocks`.

A stream that does not parse raises ValueError.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Tuple

from .container import MAGIC

_HEAD = "<BHHBBHBffBHB"
_HEAD2 = "<BBBf"
_FRAME = "<HHBBfBB"
_BLOCK = "<HHHHB"


class Parsed(NamedTuple):
    layout: Tuple
    frames: List[List[Tuple]]


class _Cursor:
    def __init__(self, data: bytes):
        self.data, self.i = data, 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.i + n > len(self.data):
            raise ValueError("stream ends early")
        out = self.data[self.i:self.i + n]
        self.i += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def varint(self) -> int:
        v = shift = 0
        while True:
            c = self.take(1)[0]
            v |= (c & 0x7F) << shift
            if not c & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError("varint too long")


def _frame(r: _Cursor, layout: list) -> List[Tuple]:
    tag = r.take(1)
    if tag != b"\0":
        raise ValueError(f"frame tag {tag!r}")
    head = r.unpack(_FRAME)
    places, blocks = [], []
    for _ in range(r.varint()):
        y0, x0, h, w, msbs = r.unpack(_BLOCK)
        band = r.varint()
        lens = []
        for _ in range(r.varint()):
            lens.append(r.varint())
            r.take(2)                       # the pass's slope
        data = r.take(r.varint())
        places.append((y0, x0, h, w, band))
        blocks.append((msbs, lens, data, (h, w)))
    layout.append((head, tuple(places)))
    return blocks


def parse(data: bytes) -> Parsed:
    r = _Cursor(bytes(data))
    if r.take(4) != MAGIC:
        raise ValueError("not a stream")
    layout: list = [r.take(struct.calcsize(_HEAD)),
                    r.take(struct.calcsize(_HEAD2)),
                    r.varint(), r.varint(), r.varint()]
    frames = []
    for _ in range(3 * r.varint()):
        frames.append(_frame(r, layout))
    for _ in range(r.varint()):
        n = r.varint()
        layout.append(r.take(n))            # frame types
        for _ in range(3 * n):
            frames.append(_frame(r, layout))
        for _ in range(n):
            start = r.i
            r.unpack("<HH")
            for _ in range(4):
                r.take(1)
                for _ in range(r.varint()):
                    r.varint()
                r.take(r.varint())
            layout.append(r.data[start:r.i])
    if r.i != len(r.data):
        raise ValueError("bytes after the stream")
    return Parsed(tuple(layout), frames)
