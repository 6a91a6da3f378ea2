"""Typed configuration for the TPU-native QSVC codec.

This is the single config schema of the framework, replacing the reference's
three-tier flag system (env-var codec registry + ``MCTF_parser.py`` argparse
vocabulary + per-binary getopt mirrors, see reference ``trunk/src/MCTF_parser.py:30-183``,
``trunk/src/mcj2k.sh:53-66``).  Field names keep the reference vocabulary so a
QSVC user finds the same knobs; derivation rules (GOP size, FHD block-size
switch, per-TRL halving schedules) match ``trunk/src/compress.py:139-142``,
``trunk/src/GOP.py:22-23``, ``trunk/src/analyze.py:121-153`` and
``trunk/src/expand.py:150-206``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

#: Reference caps the doubling search-range schedule (analyze.py:29).
SEARCH_RANGE_MAX = 128
#: Block size defaults switch at FHD area (compress.py:139-142).
RESOLUTION_FHD = 1920 * 1080
#: Useful Kakadu-style quantization slope range (texture_compress.py:45).
SLOPE_RANGE = (42000.0, 46000.0)

#: Per-TRL subband energy gains used for rate allocation
#: (texture_compress.py:112-130).  GAINS[TRLs][s] is the L/H energy gain of
#: high-band ``s`` (s=0 is the finest temporal subband H1).
GAINS = {
    2: [1.2460784922],
    3: [1.8652117304, 1.2500103877],
    4: [1.1598810146, 2.1224082769, 3.1669663339],
    5: [1.0877939347, 2.1250255455, 3.8884779989, 5.8022196044],
    6: [1.0456562538, 2.0788785438, 4.0611276369, 7.4312544148, 11.0885981772],
    7: [1.0232370223, 2.0434169985, 4.0625355976, 7.9362383342,
        14.5221257323, 21.6692913386],
    8: [1.0117165706, 2.0226778348, 4.0393126714, 8.0305936232,
        15.6879129862, 28.7065276104, 42.8346456693],
}


def gop_size(TRLs: int) -> int:
    """GOP size = 2**(TRLs-1) (reference ``GOP.py:22-23``)."""
    return 2 ** (TRLs - 1)


@dataclass(frozen=True)
class CodecConfig:
    """Full encoder/decoder configuration.

    Defaults mirror the reference CLI defaults (``compress.py:59-101``).
    """

    # --- geometry ---
    pixels_in_x: int = 352
    pixels_in_y: int = 288
    #: number of GOPs in the sequence; total pictures = GOPs * gop_size + 1
    GOPs: int = 1
    #: temporal resolution levels (TRLs); gop_size = 2**(TRLs-1)
    TRLs: int = 4
    #: spatial resolution levels for the texture codec (Kakadu ``Clevels=SRLs-1``)
    SRLs: int = 5

    # --- motion estimation / compensation ---
    block_size: int = 0          # 0 -> auto (32, or 64 at >= FHD)
    block_size_min: int = 0      # 0 -> same auto value
    border_size: int = 0
    block_overlaping: int = 0    # [sic] reference spelling kept as alias
    search_range: int = 4
    subpixel_accuracy: int = 0
    update_factor: float = 1.0 / 4
    always_B: bool = False

    # --- entropy coding / rate allocation ---
    quantization_texture: float = 45000.0
    quantization_motion: float = 45000.0
    quantization_step: float = 0.0   # 0 -> derived from SLOPE_RANGE / (nLayers-1)
    nLayers: int = 5
    #: texture codeblock size for EBCOT Tier-1 (J2K-style 2**n, <= 64)
    codeblock_size: int = 64
    #: texture entropy coder: "bp" (bit-parallel throughput mode, native)
    #: or "mq" (spec-style context-adaptive MQ, maximum compaction)
    texture_coder: str = "bp"
    #: texture codec backend: "internal" (fused device DWT + EBCOT, all
    #: scalability features) or a name from codec/backends.py
    #: ("cp" | "zlib" | "j2k" | "mj2k") — the reference's codec-registry
    #: capability (mcj2k/mcmj2k/mccp profiles, texture_compress.py:39)
    texture_backend: str = "internal"

    # --- misc ---
    FPS: float = 30.0
    components: int = 3          # YUV 4:2:0

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------

    @property
    def gop_size(self) -> int:
        return gop_size(self.TRLs)

    @property
    def pictures(self) -> int:
        """Open-GOP picture count: GOPs share one boundary frame
        (``analyze.py:110-112``)."""
        return self.GOPs * self.gop_size + 1

    @property
    def auto_block_size(self) -> int:
        if self.block_size:
            return self.block_size
        return 32 if self.pixels_in_x * self.pixels_in_y < RESOLUTION_FHD else 64

    @property
    def auto_block_size_min(self) -> int:
        if self.block_size_min:
            return min(self.block_size_min, self.auto_block_size)
        return self.auto_block_size if self.block_size else (
            32 if self.pixels_in_x * self.pixels_in_y < RESOLUTION_FHD else 64)

    def level_schedule(self) -> List["LevelParams"]:
        """Per-temporal-level parameter schedule.

        Mirrors the TRL loop of ``analyze.py:121-153``: each level halves the
        picture count and block size (floored at block_size_min) and doubles
        the search range (capped at SEARCH_RANGE_MAX).
        """
        out = []
        pictures = self.pictures
        search_range = self.search_range
        block_size = self.auto_block_size
        block_size_min = min(self.auto_block_size_min, block_size)
        for t in range(1, self.TRLs):
            out.append(LevelParams(
                temporal_subband=t,
                pictures=pictures,
                block_size=block_size,
                search_range=search_range,
            ))
            pictures = (pictures + 1) // 2
            search_range = min(search_range * 2, SEARCH_RANGE_MAX)
            block_size = max(block_size // 2, block_size_min)
        return out

    def slopes(self) -> List[List[int]]:
        """Quality-layer slope table, one row per subband.

        Row 0 is the temporal low band L_{TRLs-1}; row ``s`` (s>=1) is high
        band H_{TRLs-s} (coarsest first).  Derivation matches
        ``texture_compress.py:140-176``: base slope per subband =
        quantization + 256/sqrt(2) * GAIN, then nLayers layers spaced by
        quantization_step.
        """
        q0 = float(self.quantization_texture)
        step = self.quantization_step
        if step == 0 and self.nLayers > 1:
            step = round((SLOPE_RANGE[1] - SLOPE_RANGE[0]) / (self.nLayers - 1))
        sub_step = 256.0 / math.sqrt(2.0)
        rows: List[List[int]] = [[int(q0)]]
        if self.TRLs > 1:
            gains = GAINS[self.TRLs]
            for s in range(self.TRLs - 1):
                rows.append([int(round(q0 + sub_step * gains[s]))])
        for row in rows:
            for _ in range(self.nLayers - 1):
                row.append(int(round(row[-1] + step)))
        return rows

    def replace(self, **kw) -> "CodecConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.TRLs < 1:
            raise ValueError("TRLs must be >= 1")
        if not 0 <= self.subpixel_accuracy <= 3:
            raise ValueError("subpixel_accuracy must be in [0, 3]")
        if self.border_size < 0:
            raise ValueError("border_size must be >= 0")
        if self.block_overlaping:
            d = self.block_overlaping
            if d & (d - 1):
                raise ValueError("block_overlaping must be a power of two")
            if d > self.auto_block_size // 2:
                raise ValueError("block_overlaping must be <= block_size/2")
        if self.TRLs > 1 and self.TRLs not in GAINS:
            raise ValueError(f"no GAINS table for TRLs={self.TRLs}")
        if self.pixels_in_x % 2 or self.pixels_in_y % 2:
            raise ValueError("YUV 4:2:0 needs even frame dimensions")
        bs = self.auto_block_size
        if self.TRLs > 1 and (self.pixels_in_x % bs or self.pixels_in_y % bs):
            raise ValueError(
                f"frame dims ({self.pixels_in_x}x{self.pixels_in_y}) must be "
                f"divisible by block_size ({bs})")


@dataclass(frozen=True)
class LevelParams:
    """Parameters of one temporal decomposition level."""
    temporal_subband: int
    pictures: int
    block_size: int
    search_range: int
