"""Bit-rate accounting tables (the reference's ``info.py`` metrics system).

Copy of ``qsvc_tpu/scal/info.py``.  Walks a
:class:`~qsvc_tpu_torch.codec.codestream.VideoStream` and produces the
same table schema as ``info.py:81-403``:

* per-sequence kbps per subband x {texture, motion};
* the per-GOP table (``info.py:211-281``): GOP 0 is the first L frame
  alone; every further GOP row lists its L frame's kbps, then per
  temporal subband (coarsest first) the frame-type characters, motion
  kbps and texture kbps of the frames that belong to that GOP, and the
  row total;
* exact per-frame byte attribution via the MCTF dependency closure
  (``info.py:293-334`` walks an approximate single chain; here the TRUE
  decode closure is used — a B frame depends on its own H+M section and
  recursively on BOTH of its reference frames, an I frame only on its own
  texture section, and every section is counted once).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

from ..codec.codestream import VideoStream


@dataclass
class GOPRow:
    """One row of the per-GOP kbps table."""
    gop: int
    L_kbps: float
    #: per temporal subband, coarsest first: (frame_types, M_kbps, H_kbps)
    subbands: List[Tuple[str, float, float]]

    @property
    def total_kbps(self) -> float:
        return self.L_kbps + sum(m + h for _, m, h in self.subbands)


@dataclass
class StreamInfo:
    fps: float
    gop_size: int
    pictures: int
    texture_bytes: Dict[str, int]        # "L", "H1".., per subband totals
    motion_bytes: Dict[str, int]
    per_frame_texture: List[List[int]]   # levels finest..coarsest, then L
    per_frame_motion: List[List[int]]
    frame_types: List[bytes]             # per level (finest first)

    @property
    def total_bytes(self) -> int:
        return sum(self.texture_bytes.values()) + \
            sum(self.motion_bytes.values())

    @property
    def kbps(self) -> float:
        seconds = self.pictures / self.fps
        return self.total_bytes * 8.0 / 1000.0 / seconds

    def subband_kbps(self) -> Dict[str, float]:
        seconds = self.pictures / self.fps
        out = {}
        for k, v in self.texture_bytes.items():
            out[k] = v * 8.0 / 1000.0 / seconds
        for k, v in self.motion_bytes.items():
            out[k] = v * 8.0 / 1000.0 / seconds
        return out

    # ----------------------------------------------------- per-GOP table

    def gop_table(self) -> List[GOPRow]:
        """kbps per GOP x subband (info.py:211-281): GOP 0 = the first L
        frame; GOP n >= 1 groups its own L frame and, per subband
        (coarsest first), the 2^(s-1) H/M frames it owns."""
        T = len(self.per_frame_texture)      # TRLs (levels + L row)
        gop_time = self.gop_size / self.fps
        gop0_time = 1.0 / self.fps
        L_tex = self.per_frame_texture[-1]
        gops = len(L_tex) - 1

        def kbps(nbytes: float, t: float) -> float:
            return nbytes * 8.0 / 1000.0 / t

        rows = [GOPRow(0, kbps(L_tex[0], gop0_time), [])]
        for g in range(1, gops + 1):
            subbands = []
            # coarsest temporal subband first (level index T-2 .. 0)
            for lev in range(T - 2, -1, -1):
                n = 1 << (T - 2 - lev)       # frames of this level per GOP
                lo = (g - 1) * n
                ft = self.frame_types[lev][lo:lo + n].decode()
                m = sum(self.per_frame_motion[lev][lo:lo + n])
                h = sum(self.per_frame_texture[lev][lo:lo + n])
                subbands.append((ft, kbps(m, gop_time), kbps(h, gop_time)))
            rows.append(GOPRow(g, kbps(L_tex[g], gop_time), subbands))
        return rows

    # ------------------------------------------- exact per-frame closure

    def frame_closure(self, n: int) -> Set[Tuple]:
        """The exact set of stream sections frame ``n`` needs to decode:
        ("L", i) or ("H", level, pair) — every B frame pulls its own
        residue+motion section and BOTH of its references, recursively;
        an I frame only its own texture section (it decodes standalone,
        decorrelate.cpp:1036-1061).  The update-step coupling is excluded
        (the reference's accounting also treats update as free,
        info.py:293-334)."""
        T = len(self.per_frame_texture)
        sections: Set[Tuple] = set()

        def visit(lev: int, i: int) -> None:
            if lev == T - 1:
                sections.add(("L", i))
                return
            if i % 2 == 0:
                visit(lev + 1, i // 2)
                return
            pair = i // 2
            sections.add(("H", lev, pair))
            if self.frame_types[lev][pair:pair + 1] == b"B":
                visit(lev, i - 1)
                visit(lev, i + 1)

        visit(0, n)
        return sections

    def frame_cost(self, n: int) -> int:
        """Byte cost of decoding frame ``n`` (exact closure).  B-frame
        sections count texture+motion; I frames only texture (their
        motion fields are zeroed, decorrelate.cpp:1007-1022)."""
        cost = 0
        for sec in self.frame_closure(n):
            if sec[0] == "L":
                cost += self.per_frame_texture[-1][sec[1]]
            else:
                _, lev, pair = sec
                cost += self.per_frame_texture[lev][pair]
                if self.frame_types[lev][pair:pair + 1] == b"B":
                    cost += self.per_frame_motion[lev][pair]
        return cost


def stream_info(vs: VideoStream, fps: float = 0.0) -> StreamInfo:
    cfg = vs.cfg
    fps = fps or cfg.FPS
    tex = vs.texture_bytes()
    mot = vs.motion_bytes()
    per_tex: List[List[int]] = []
    per_mot: List[List[int]] = []
    ftypes: List[bytes] = []
    for lev in vs.levels:
        per_tex.append([sum(f.total_bytes for f in fr.values())
                        for fr in lev.high])
        per_mot.append([sum(len(d) for d, _, _ in m["parts"])
                        for m in lev.motion])
        ftypes.append(lev.frame_types)
    per_tex.append([sum(f.total_bytes for f in fr.values())
                    for fr in vs.low])
    per_mot.append([0] * len(vs.low))
    return StreamInfo(fps, cfg.gop_size, cfg.pictures, tex, mot,
                      per_tex, per_mot, ftypes)


def format_table(si: StreamInfo) -> str:
    """Human-readable tables (the ``info`` CLI output): per-subband
    totals followed by the per-GOP table (info.py:211-281 schema)."""
    lines = [f"pictures={si.pictures} gop_size={si.gop_size} "
             f"fps={si.fps:g} total={si.total_bytes} bytes "
             f"({si.kbps:.1f} kbps)"]
    lines.append(f"{'subband':>8} {'bytes':>10} {'kbps':>10}")
    sec = si.pictures / si.fps
    for k in sorted(si.texture_bytes):
        b = si.texture_bytes[k]
        lines.append(f"{k:>8} {b:>10} {b*8/1000/sec:>10.2f}")
    for k in sorted(si.motion_bytes):
        b = si.motion_bytes[k]
        lines.append(f"{k:>8} {b:>10} {b*8/1000/sec:>10.2f}")
    lines.append("")
    T = len(si.per_frame_texture)
    hdr = " GOP" + f" {'L':>8}"
    for lev in range(T - 2, -1, -1):
        hdr += f"  {'types':>8} {'M' + str(lev + 1):>7} {'H' + str(lev + 1):>7}"
    lines.append(hdr + f" {'total':>8}")
    for row in si.gop_table():
        s = f"{row.gop:04d} {row.L_kbps:>8.1f}"
        for (ft, m, h) in row.subbands:
            s += f"  {ft:>8} {m:>7.1f} {h:>7.1f}"
        lines.append(s + f" {row.total_kbps:>8.1f}")
    return "\n".join(lines)
