"""Multi-level separable 2D DWT in the reference's packed layout.

Frozen copy of ``qsvc_tpu_torch/ops/dwt2d.py`` (``trunk/src/dwt2d.cpp:76-175``
semantics): at each level the active top-left sub-array is transformed
rows-then-columns, low half first, high half after; after L levels the
top-left corner holds the LL band.  Leading axes are batch axes.  The
active size shrinks per level as ``n -> (n >> 1 or 1)``.  Every bank of
``lifting.FILTERS`` applies: the 5/3 and 9/7 passes run along their axis
in place, the others with the axis moved last.
"""

from __future__ import annotations

from typing import List

import torch

from . import lifting


def _level_sizes(n: int, levels: int) -> List[int]:
    """Active sizes per level: [n, n>>1 or 1, ...] (dwt2d.cpp:78-81)."""
    out = [n]
    for _ in range(levels):
        n = max(n >> 1, 1)
        out.append(n)
    return out


def _fwd_axis(x: torch.Tensor, filt: str, axis: int) -> torch.Tensor:
    """One packed forward 1D transform along ``axis`` (low | high).  The
    5/3 and 9/7 banks run along either of the last two axes in place;
    the others run on the last axis, so the column pass moves the axis
    there and back."""
    if filt in lifting.AXIS_AWARE:
        l, h = lifting.fwd(filt, x, axis=axis)
        return torch.cat([l, h], dim=axis)
    l, h = lifting.fwd(filt, x.movedim(axis, -1))
    return torch.cat([l, h], dim=-1).movedim(-1, axis)


def _inv_axis(x: torch.Tensor, filt: str, axis: int, n_low: int
              ) -> torch.Tensor:
    if filt in lifting.AXIS_AWARE:
        if axis == -1:
            return lifting.inv(filt, x[..., :n_low], x[..., n_low:],
                               axis=axis)
        return lifting.inv(filt, x[..., :n_low, :], x[..., n_low:, :],
                           axis=axis)
    xm = x.movedim(axis, -1)
    return lifting.inv(filt, xm[..., :n_low], xm[..., n_low:]).movedim(
        -1, axis)


def analyze(x: torch.Tensor, levels: int, filt: str = "5/3") -> torch.Tensor:
    """Packed multi-level forward 2D DWT over the last two axes
    (dwt2d.cpp:76-119): per level, rows first then columns."""
    if filt == "9/7" and not x.is_floating_point():
        x = x.to(torch.float32)
    H, W = x.shape[-2], x.shape[-1]
    ys = _level_sizes(H, levels)
    xs = _level_sizes(W, levels)
    x = x.clone()
    for lv in range(levels):
        ny, nx = ys[lv], xs[lv]
        sub = x[..., :ny, :nx]
        sub = _fwd_axis(sub, filt, -1)   # rows
        sub = _fwd_axis(sub, filt, -2)   # columns
        x[..., :ny, :nx] = sub
    return x


def synthesize(x: torch.Tensor, levels: int, filt: str = "5/3"
               ) -> torch.Tensor:
    """Packed multi-level inverse 2D DWT (dwt2d.cpp:128-175): per level,
    columns first then rows."""
    if filt == "9/7" and not x.is_floating_point():
        x = x.to(torch.float32)
    H, W = x.shape[-2], x.shape[-1]
    ys = _level_sizes(H, levels)
    xs = _level_sizes(W, levels)
    x = x.clone()
    for lv in range(levels - 1, -1, -1):
        ny, nx = ys[lv], xs[lv]
        # for odd n the low band holds ceil(n/2) samples
        nly = ny - (ny // 2)
        nlx = nx - (nx // 2)
        sub = x[..., :ny, :nx]
        sub = _inv_axis(sub, filt, -2, nly)  # columns
        sub = _inv_axis(sub, filt, -1, nlx)  # rows
        x[..., :ny, :nx] = sub
    return x


# ---------------------------------------------------------------------------
# Interpolation helpers (zero the high bands and synthesize; keep the LL
# band of one analysis level) — chroma 4:2:0 <-> 4:4:4 in the MCTF path
# ---------------------------------------------------------------------------

def _interp_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero-high 5/3 synthesis along one axis, closed form: even = low,
    odd = ``tdiv(l[i] + l[i+1], 2)`` with the right edge replicated."""
    if axis == -1:
        nxt = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
        odd = lifting.tdiv(x + nxt, 2)
        out = torch.stack([x, odd], dim=-1)
        return out.reshape(out.shape[:-2] + (2 * x.shape[-1],))
    assert axis == -2
    nxt = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    odd = lifting.tdiv(x + nxt, 2)
    out = torch.stack([x, odd], dim=-2)
    return out.reshape(out.shape[:-3] + (2 * x.shape[-2],) + x.shape[-1:])


def _low_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Forward 5/3 low band along one even-length axis, closed form."""
    if axis == -1:
        se, so = x[..., 0::2], x[..., 1::2]
        se_next = torch.cat([se[..., 1:], se[..., -1:]], dim=-1)
        h = so - lifting.tdiv(se + se_next, 2)
        h_left = torch.cat([h[..., :1], h[..., :-1]], dim=-1)
        return se + lifting.tdiv(h + h_left, 4)
    assert axis == -2
    se, so = x[..., 0::2, :], x[..., 1::2, :]
    se_next = torch.cat([se[..., 1:, :], se[..., -1:, :]], dim=-2)
    h = so - lifting.tdiv(se + se_next, 2)
    h_left = torch.cat([h[..., :1, :], h[..., :-1, :]], dim=-2)
    return se + lifting.tdiv(h + h_left, 4)


def upsample2(x: torch.Tensor, filt: str = "5/3") -> torch.Tensor:
    """Interpolate x2 in both dimensions: ``x`` as the LL band of a
    double-size canvas with zero high bands, one synthesis level (5/3:
    closed form, columns then rows like ``synthesize``)."""
    if filt == "5/3":
        return _interp_axis(_interp_axis(x, -2), -1)
    H, W = x.shape[-2], x.shape[-1]
    canvas = x.new_zeros(x.shape[:-2] + (2 * H, 2 * W))
    canvas[..., :H, :W] = x
    return synthesize(canvas, 1, filt)


def downsample2(x: torch.Tensor, filt: str = "5/3") -> torch.Tensor:
    """One analysis level, returning the LL band (5/3 with even dims:
    closed form, rows then columns like ``analyze``)."""
    H, W = x.shape[-2], x.shape[-1]
    if filt == "5/3" and H % 2 == 0 and W % 2 == 0:
        return _low_axis(_low_axis(x, -1), -2)
    packed = analyze(x, 1, filt)
    return packed[..., :H - H // 2, :W - W // 2]


def ll_view(x: torch.Tensor, levels: int) -> torch.Tensor:
    """The LL band of a packed ``levels``-deep pyramid (top-left corner)."""
    ys = _level_sizes(x.shape[-2], levels)
    xs = _level_sizes(x.shape[-1], levels)
    return x[..., :ys[-1], :xs[-1]]
