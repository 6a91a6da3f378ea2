"""Integer 5/3 and float 9/7 lifting filter banks on torch tensors.

Port of ``qsvc_tpu/ops/lifting.py`` (the 5/3 and 9/7 banks; Haar, 13/7
and S+P are not ported yet).  Semantics are the reference's
(``trunk/src/5_3.cpp:39-115``): integer lifting with C truncating
division, separate even/odd-length boundary rules, perfect
reconstruction.  Each lifting step is one whole-axis tensor op along the
last or the second-to-last axis; leading axes broadcast.  The 9/7 bank
runs one torch op per lifting step, so its float32 rounding follows the
step order of the JAX version (steps are never fused).
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
    "9/7": (fwd97, inv97),
}


def fwd(name: str, s: torch.Tensor, axis: int = -1):
    return FILTERS[name][0](s, axis=axis)


def inv(name: str, l: torch.Tensor, h: torch.Tensor, axis: int = -1):
    return FILTERS[name][1](l, h, axis=axis)
