"""MQ arithmetic coder (JPEG 2000 / ITU-T T.88 semantics).

Port of ``qsvc_tpu/codec/mq.py``: the context-adaptive binary arithmetic
coder of EBCOT Tier-1, from the published standard's state machine (the
47-entry Qe table with NMPS/NLPS/SWITCH transitions, byte-stuffing
around 0xFF, carry handling), in pure Python.

This is the spec twin of the native coder (``native/ebcot.cpp``, built
by :mod:`.fast`), which the codec runs; tests and users reach this one
by name.  The two write the same bytes.

Per-pass termination: Tier-1 calls :meth:`MQEncoder.flush` at every coding
pass boundary (the standard's TERMALL option).  Contexts persist across
segments; each pass's bytes form an independently decodable segment, which
makes layer truncation exact and per-pass parallel decode possible.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# (Qe, NMPS, NLPS, SWITCH) — ITU-T T.88 Table E.1 (public standard constants)
QE_TABLE: Tuple[Tuple[int, int, int, int], ...] = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

# Tier-1 context numbering (T.800 numbering convention)
N_CONTEXTS = 19
CTX_UNIFORM = 18
CTX_RUNLENGTH = 17

# Initial (index, MPS) per context: UNIFORM starts at state 46, run-length
# at 3, all-zero context 0 at 4, others at 0 (T.800 D.4.2).
INITIAL_STATES = {0: 4, CTX_RUNLENGTH: 3, CTX_UNIFORM: 46}


def initial_context_states() -> List[List[int]]:
    st = [[0, 0] for _ in range(N_CONTEXTS)]
    for cx, idx in INITIAL_STATES.items():
        st[cx][0] = idx
    return st


class MQEncoder:
    """MQ encoder over a shared context state table."""

    def __init__(self):
        self.ctx = initial_context_states()
        self._reset_interval()
        self.out = bytearray()
        self.segment_starts: List[int] = [0]

    def _reset_interval(self):
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self.b = -1          # "pending" byte; -1 = none yet in this segment
        self.pending: bytearray = bytearray()

    # --- T.88 encoder procedures -------------------------------------

    def _byteout(self):
        if self.b == 0xFF:
            self._push()
            self.b = (self.c >> 20) & 0xFF
            self.c &= 0xFFFFF
            self.ct = 7
        else:
            if self.c < 0x8000000:
                self._push()
                self.b = (self.c >> 19) & 0xFF
                self.c &= 0x7FFFF
                self.ct = 8
            else:
                self.b += 1
                if self.b == 0xFF:
                    self.c &= 0x7FFFFFF
                    self._push()
                    self.b = (self.c >> 20) & 0xFF
                    self.c &= 0xFFFFF
                    self.ct = 7
                else:
                    self._push()
                    self.b = (self.c >> 19) & 0xFF
                    self.c &= 0x7FFFF
                    self.ct = 8

    def _push(self):
        if self.b >= 0:
            self.pending.append(self.b)

    def _renorm(self):
        while True:
            if self.ct == 0:
                self._byteout()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break

    def encode(self, bit: int, cx: int):
        idx, mps = self.ctx[cx]
        qe, nmps, nlps, switch = QE_TABLE[idx]
        self.a -= qe
        if bit == mps:
            if self.a & 0x8000:
                self.c += qe
            else:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.ctx[cx][0] = nmps
                self._renorm()
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                self.ctx[cx][1] = 1 - mps
            self.ctx[cx][0] = nlps
            self._renorm()

    def flush(self) -> int:
        """Terminate the current segment; returns the segment end offset in
        :attr:`out`.  Contexts persist; the arithmetic interval restarts for
        the next segment.

        Guarded variant of the T.88 FLUSH: the standard's SETBITS top-aligns
        the codeword inside the final interval, which is only safe when the
        bytes following the segment are zeros — a decoder that synthesizes
        1-bits past a *terminated* segment (T.800 truncation behaviour, and
        ours) can be pushed past the interval top and mis-decode the last
        symbols.  We instead round the codeword DOWN to the precision the
        two flush bytes can carry, with one-ulp headroom, so the all-ones
        tail still decodes inside [C, C+A).  (A >= 0x8000 guarantees such a
        value exists.)  Stream format is unchanged; only the chosen codeword
        differs, so any spec decoder remains compatible."""
        # lowest bit of C the two flushed bytes can represent (conservative
        # over the 0xFF-stuffing case), given ct pending renorm shifts
        p = max(13 - self.ct, 0)
        tempc = ((self.c + self.a - 1 - (1 << (p + 1))) >> p) << p
        if self.c < tempc:
            self.c = tempc
        self.c = (self.c << self.ct) & 0xFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFF
        self._byteout()
        if self.b != 0xFF and self.b >= 0:
            self.pending.append(self.b)
        self.out.extend(self.pending)
        # drop a trailing 0xFF (decoder synthesizes 1-bits past the end)
        if self.out and self.out[-1] == 0xFF:
            del self.out[-1]
        self._reset_interval()
        self.segment_starts.append(len(self.out))
        return len(self.out)

    def get_bytes(self) -> bytes:
        return bytes(self.out)


class MQDecoder:
    """MQ decoder over a shared context state table; decodes a sequence of
    independently terminated segments (matching per-pass flushes)."""

    def __init__(self, data: bytes):
        self.ctx = initial_context_states()
        self.data = data
        self.bp = 0
        self.end = len(data)
        self._init_interval()

    def start_segment(self, start: int, end: int):
        """Begin decoding a segment spanning data[start:end]."""
        self.bp = start
        self.end = min(end, len(self.data))
        self._init_interval()

    def _byte(self, i: int) -> int:
        if i < self.end:
            return self.data[i]
        return 0xFF          # truncated stream: synthesize 0xFF (T.800 B.10)

    def _init_interval(self):
        self.b = self._byte(self.bp)
        self.c = self.b << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        if self.b == 0xFF:
            if self._byte(self.bp + 1) > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.b = self._byte(self.bp)
                self.c += self.b << 9
                self.ct = 7
        else:
            self.bp += 1
            self.b = self._byte(self.bp)
            self.c += self.b << 8
            self.ct = 8

    def _renorm(self):
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break

    def decode(self, cx: int) -> int:
        idx, mps = self.ctx[cx]
        qe, nmps, nlps, switch = QE_TABLE[idx]
        self.a -= qe
        chigh = (self.c >> 16) & 0xFFFF
        if chigh < qe:
            # LPS exchange path
            if self.a < qe:
                d = mps
                self.ctx[cx][0] = nmps
            else:
                d = 1 - mps
                if switch:
                    self.ctx[cx][1] = 1 - mps
                self.ctx[cx][0] = nlps
            self.a = qe
            self._renorm()
        else:
            self.c -= qe << 16
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    d = 1 - mps
                    if switch:
                        self.ctx[cx][1] = 1 - mps
                    self.ctx[cx][0] = nlps
                else:
                    d = mps
                    self.ctx[cx][0] = nmps
                self._renorm()
            else:
                d = mps
        return d
