"""Integer lifting filter banks (Haar, 5/3, 13/7, S+P) and the float 9/7
bank on torch tensors.

Port of ``qsvc_tpu/ops/lifting.py``.  Semantics are the reference's
(``trunk/src/Haar.cpp:39-89``, ``5_3.cpp:39-115``, ``13_7.cpp``,
``SP.cpp``): integer lifting with separate even/odd-length boundary
rules and perfect reconstruction.  Haar and 5/3 divide with C truncation
(:func:`tdiv`); 13/7 and S+P divide with arithmetic shifts (floor), as
``>>`` does on torch integer tensors.  Each lifting step is one
whole-axis tensor op; leading axes broadcast.  The 5/3 and 9/7 banks run
along the last or the second-to-last axis (:data:`AXIS_AWARE`), the
others along the last.  The 9/7 bank runs one torch op per lifting step,
so its float32 rounding follows the step order of the JAX version (steps
are never fused).
"""

from __future__ import annotations

from typing import Tuple

import torch


def tdiv(x: torch.Tensor, d: int) -> torch.Tensor:
    """C-style truncating integer division (round toward zero)."""
    return torch.div(x, d, rounding_mode="trunc")


def _ops(axis: int):
    """Axis-aware slice/concat helpers for axis -1 or -2."""
    if axis == -1:
        return (lambda x, s: x[..., s],
                lambda parts: torch.cat(parts, dim=-1))
    assert axis == -2
    return (lambda x, s: x[..., s, :],
            lambda parts: torch.cat(parts, dim=-2))


def _split_phases(s: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    sl, _ = _ops(axis)
    return sl(s, slice(0, None, 2)), sl(s, slice(1, None, 2))


def _interleave(even: torch.Tensor, odd: torch.Tensor, n: int,
                axis: int = -1) -> torch.Tensor:
    """Inverse of _split_phases for a length-n signal."""
    if axis == -1:
        out = even.new_zeros(even.shape[:-1] + (n,))
        out[..., 0::2] = even
        out[..., 1::2] = odd
        return out
    assert axis == -2
    out = even.new_zeros(even.shape[:-2] + (n,) + even.shape[-1:])
    out[..., 0::2, :] = even
    out[..., 1::2, :] = odd
    return out


# ---------------------------------------------------------------------------
# 5/3 filter bank (reference 5_3.cpp:39-115 semantics)
# ---------------------------------------------------------------------------

def fwd53(s: torch.Tensor, axis: int = -1
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward 5/3 lifting along ``axis``; returns ``(low, high)`` with
    ``ceil(n/2)`` and ``floor(n/2)`` samples."""
    sl, cat = _ops(axis)
    n = s.shape[axis]
    if n == 1:
        return s, sl(s, slice(0, 0))
    se, so = _split_phases(s, axis)
    if n % 2 == 0:
        se_next = cat([sl(se, slice(1, None)), sl(se, slice(-1, None))])
        h = so - tdiv(se + se_next, 2)
        h_left = cat([sl(h, slice(0, 1)), sl(h, slice(None, -1))])
        l = se + tdiv(h + h_left, 4)
    else:
        h = so - tdiv(sl(se, slice(None, -1)) + sl(se, slice(1, None)), 2)
        h_left = cat([sl(h, slice(0, 1)), h])
        h_right = cat([h, sl(h, slice(-1, None))])
        l = se + tdiv(h_right + h_left, 4)
    return l, h


def inv53(l: torch.Tensor, h: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse 5/3 lifting; exact inverse of :func:`fwd53`."""
    sl, cat = _ops(axis)
    m = h.shape[axis]
    n = l.shape[axis] + m
    if m == 0:
        return l
    if n % 2 == 0:
        h_left = cat([sl(h, slice(0, 1)), sl(h, slice(None, -1))])
        se = l - tdiv(h + h_left, 4)
        se_next = cat([sl(se, slice(1, None)), sl(se, slice(-1, None))])
        so = h + tdiv(se + se_next, 2)
    else:
        h_left = cat([sl(h, slice(0, 1)), h])
        h_right = cat([h, sl(h, slice(-1, None))])
        se = l - tdiv(h_right + h_left, 4)
        so = h + tdiv(sl(se, slice(None, -1)) + sl(se, slice(1, None)), 2)
    return _interleave(se, so, n, axis)


# ---------------------------------------------------------------------------
# Haar (2/1) filter bank (reference Haar.cpp:39-89 semantics)
# ---------------------------------------------------------------------------

def fwd_haar(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward Haar lifting: ``h = s_odd - s_even; l = s_even + h/2``.

    Odd n: the trailing sample passes through to the low band."""
    n = s.shape[-1]
    if n == 1:
        return s, s[..., :0]
    se, so = _split_phases(s)
    if n % 2 == 0:
        h = so - se
        l = se + tdiv(h, 2)
    else:
        h = so - se[..., :-1]
        l = torch.cat([se[..., :-1] + tdiv(h, 2), se[..., -1:]], dim=-1)
    return l, h


def inv_haar(l: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    m = h.shape[-1]
    n = l.shape[-1] + m
    if m == 0:
        return l
    if n % 2 == 0:
        se = l - tdiv(h, 2)
        so = se + h
    else:
        se_head = l[..., :-1] - tdiv(h, 2)
        so = se_head + h
        se = torch.cat([se_head, l[..., -1:]], dim=-1)
    return _interleave(se, so, n)


# ---------------------------------------------------------------------------
# 13/7 filter bank (reference 13_7.cpp:39-183 — cubic integer lifting with
# arithmetic-shift (floor) division and short-filter boundary fallbacks)
# ---------------------------------------------------------------------------
#
# The reference's boundary unrolling reads out of bounds for n == 3; as in
# the JAX version, the reference formulas are kept for all in-bounds cases
# and the out-of-range high-band neighbour indices clamp at n == 3.

def _edge(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Replicate-pad the last axis by (left, right)."""
    parts = []
    if left:
        parts.append(x[..., :1].expand(*x.shape[:-1], left))
    parts.append(x)
    if right:
        parts.append(x[..., -1:].expand(*x.shape[:-1], right))
    return torch.cat(parts, dim=-1)


def _iota_last(m: int, batch: Tuple[int, ...], device) -> torch.Tensor:
    return torch.arange(m, dtype=torch.int32, device=device).expand(
        *batch, m)


def _h137(se: torch.Tensor, so: torch.Tensor, even: bool) -> torch.Tensor:
    """13/7 high-band predict step; ``se`` has one extra sample when odd."""
    m = so.shape[-1]
    e = _edge(se, 1, 2 if even else 1)
    ei_1, ei, ei1, ei2 = (e[..., k:k + m] for k in range(4))
    hA = so - ((9 * (ei + ei1) - (ei_1 + ei2) + 8) >> 4)   # interior cubic
    hB = so - ((ei + ei1 + 1) >> 1)                        # rounded average
    hC = so - ei                                           # Haar-like edge
    i = _iota_last(m, so.shape[:-1], so.device)
    if even:
        # last writer wins: h[m-1]=hC, h[m-2]=hB, h[0]=hC, interior hA
        return torch.where(i == m - 1, hC,
               torch.where(i == m - 2, hB,
               torch.where(i == 0, hC, hA)))
    return torch.where((i == 0) | (i == m - 1), hB, hA)


def _l137(se: torch.Tensor, h: torch.Tensor, even: bool) -> torch.Tensor:
    nl = se.shape[-1]
    m = h.shape[-1]
    hh = _edge(h, 2, max(0, nl + 2 - m))
    hi_2, hi_1, hi, hi1 = (hh[..., k:k + nl] for k in range(4))
    lA = se + ((-hi_2 + 9 * (hi_1 + hi) - hi1 + 16) >> 5)  # interior cubic
    lB = se + ((hi_1 + hi + 1) >> 2)                       # 5/3-like edge
    lC = se + (hi >> 1)                                    # first sample
    lD = se + (hi_1 >> 1)                                  # trailing odd one
    i = _iota_last(nl, se.shape[:-1], se.device)
    if even:
        return torch.where(i == nl - 1, lB,
               torch.where(i == 1, lB,
               torch.where(i == 0, lC, lA)))
    # low band has m+1 samples; reference write order: l[0], l[1],
    # l[2..m-2], l[m-1], l[m] — last writer wins.
    return torch.where(i == nl - 1, lD,
           torch.where(i == nl - 2, lB,
           torch.where(i == 1, lB,
           torch.where(i == 0, lC, lA))))


def fwd137(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward 13/7 cubic lifting along the last axis (13_7.cpp:39-103)."""
    n = s.shape[-1]
    if n == 1:
        return s, s[..., :0]
    se, so = _split_phases(s)
    if n == 2:
        h = so - se
        return se + (h >> 1), h
    even = n % 2 == 0
    h = _h137(se, so, even)
    return _l137(se, h, even), h


def inv137(l: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    m = h.shape[-1]
    n = l.shape[-1] + m
    if m == 0:
        return l
    if n == 2:
        se = l - (h >> 1)
        return _interleave(se, se + h, n)
    even = n % 2 == 0
    # invert the update step: se = l - (the same update computed from h);
    # _l137 and _h137 are exactly linear in their zeroed argument
    se = l - _l137(torch.zeros_like(l), h, even)
    # invert the predict step: _h137 with so = 0 returns -prediction
    so = h - _h137(se, torch.zeros_like(h), even)
    return _interleave(se, so, n)


# ---------------------------------------------------------------------------
# S+P filter bank (reference SP.cpp:39-133).  The reference's even_analyze
# never initializes the high band before updating it (disabled code
# upstream); as the JAX version does, both parities use the odd path's
# ``h = s_even - s_odd`` initialization, the standard S+P transform.
# ---------------------------------------------------------------------------

def _sp_diffs(l: torch.Tensor, m: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d1, d2) with d1[i] = d[i-1] and d2[i] = d[i], where
    d[i] = l[i] - l[i+1], edge-clamped beyond its ends."""
    d = l[..., :m] - l[..., 1:m + 1] if l.shape[-1] > m else \
        l[..., :m - 1] - l[..., 1:m]
    dpad = _edge(d, 1, max(0, m - d.shape[-1]))      # dpad[..., i] == d[i-1]
    d1 = dpad[..., :m]
    d2 = (dpad[..., 1:m + 1] if dpad.shape[-1] >= m + 1
          else _edge(d, 0, 1)[..., :m])
    return d1, d2


def fwd_sp(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n = s.shape[-1]
    if n == 1:
        return s, s[..., :0]
    se, so = _split_phases(s)
    if n % 2 == 0:
        l = (se + so) >> 1
        h = se - so
    else:
        h = se[..., :-1] - so
        l = torch.cat([(se[..., :-1] + so) >> 1, se[..., -1:]], dim=-1)
    m = h.shape[-1]
    if m >= 2:
        # the boundary rules of SP.cpp:
        #   h[0]   -= d[0] >> 2
        #   h[i]   -= ((d[i-1] + d[i] - h_raw[i+1]) * 2 + d[i] + 3) >> 3
        #   h[m-1] -= d[m-2] >> 2
        d1, d2 = _sp_diffs(l, m)
        h_next = torch.cat([h[..., 1:], h[..., -1:]], dim=-1)
        interior = (((d1 + d2 - h_next) << 1) + d2 + 3) >> 3
        i = _iota_last(m, h.shape[:-1], h.device)
        h = h - torch.where(i == 0, d2 >> 2,
                            torch.where(i == m - 1, d1 >> 2, interior))
    return l, h


def inv_sp(l: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    m = h.shape[-1]
    n = l.shape[-1] + m
    if m == 0:
        return l
    if m >= 2:
        # restore the raw h by a backward recurrence, h_raw[i] depending
        # on h_raw[i+1]: one column per step, each step whole-batch ops
        # (the JAX version's lax.scan)
        d1, d2 = _sp_diffs(l, m)
        raw = torch.empty_like(h)
        raw[..., m - 1] = h[..., m - 1] + (d1[..., m - 1] >> 2)
        for i in range(m - 2, 0, -1):
            raw[..., i] = h[..., i] + ((((d1[..., i] + d2[..., i]
                                          - raw[..., i + 1]) << 1)
                                        + d2[..., i] + 3) >> 3)
        raw[..., 0] = h[..., 0] + (d2[..., 0] >> 2)
        h = raw
    # undo the pair transform: se = l + ((h+1)>>1); so = se - h
    if n % 2 == 0:
        se = l + ((h + 1) >> 1)
        return _interleave(se, se - h, n)
    se_head = l[..., :-1] + ((h + 1) >> 1)
    so = se_head - h
    return _interleave(torch.cat([se_head, l[..., -1:]], dim=-1), so, n)


# ---------------------------------------------------------------------------
# 9/7 irreversible (float) filter bank — CDF 9/7 lifting with symmetric
# (whole-sample) extension, the public lifting coefficients.
# ---------------------------------------------------------------------------

A97 = -1.586134342059924
B97 = -0.052980118572961
G97 = 0.882911075530934
D97 = 0.443506852043971
K97 = 1.230174104914001


def _lift_odd(se, so, coef, n_even_extra, axis=-1):
    """so += coef * (se_i + se_{i+1}) with symmetric edge clamping."""
    sl, cat = _ops(axis)
    if n_even_extra:                      # odd n: se has one extra sample
        left = sl(se, slice(None, -1))
        right = sl(se, slice(1, None))
    else:                                 # even n: clamp right edge
        left = se
        right = cat([sl(se, slice(1, None)), sl(se, slice(-1, None))])
    return so + coef * (left + right)


def _lift_even(se, so, coef, axis=-1):
    """se += coef * (so_{i-1} + so_i) with symmetric edge clamping."""
    sl, cat = _ops(axis)
    nl = se.shape[axis]
    so_left = sl(cat([sl(so, slice(0, 1)), so]), slice(None, nl))
    so_right = sl(cat([so, sl(so, slice(-1, None))]), slice(None, nl))
    return se + coef * (so_left + so_right)


def fwd97(s: torch.Tensor, axis: int = -1
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward CDF 9/7 lifting (float32) along ``axis``."""
    sl, _ = _ops(axis)
    n = s.shape[axis]
    if n == 1:
        return s, sl(s, slice(0, 0))
    se, so = _split_phases(s, axis)
    odd_n = n % 2 == 1
    so = _lift_odd(se, so, A97, odd_n, axis)
    se = _lift_even(se, so, B97, axis)
    so = _lift_odd(se, so, G97, odd_n, axis)
    se = _lift_even(se, so, D97, axis)
    return se * (1.0 / K97), so * K97


def inv97(l: torch.Tensor, h: torch.Tensor, axis: int = -1) -> torch.Tensor:
    m = h.shape[axis]
    n = l.shape[axis] + m
    if m == 0:
        return l
    se = l * K97
    so = h * (1.0 / K97)
    odd_n = n % 2 == 1
    se = _lift_even(se, so, -D97, axis)
    so = _lift_odd(se, so, -G97, odd_n, axis)
    se = _lift_even(se, so, -B97, axis)
    so = _lift_odd(se, so, -A97, odd_n, axis)
    return _interleave(se, so, n, axis)


FILTERS = {
    "5/3": (fwd53, inv53),
    "haar": (fwd_haar, inv_haar),
    "13/7": (fwd137, inv137),
    "sp": (fwd_sp, inv_sp),
    "9/7": (fwd97, inv97),
}


AXIS_AWARE = {"5/3", "9/7"}     # run natively along axis -1 or -2


def fwd(name: str, s: torch.Tensor, axis: int = -1):
    if axis == -1:
        return FILTERS[name][0](s)
    return FILTERS[name][0](s, axis=axis)


def inv(name: str, l: torch.Tensor, h: torch.Tensor, axis: int = -1):
    if axis == -1:
        return FILTERS[name][1](l, h)
    return FILTERS[name][1](l, h, axis=axis)
