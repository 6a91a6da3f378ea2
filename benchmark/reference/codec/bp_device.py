"""Device-side simulation of the bp Tier-1 coder's rate/distortion
accounting (frozen copy of ``qsvc_tpu_torch/codec/bp_device.py``).

The native bp coder (``native/ebcot.cpp`` ``bp::encode_block``) codes each
code-block in 3 passes per bit-plane and records per-pass byte ends and
SSE; both are deterministic functions of the coefficients.  Because the
bp format freezes pass membership at plane start, the significance
entering plane ``p`` is ``(mag >> (p+1)) != 0``: every plane reduces
independently to per-block statistics, and only the final prefix-slope
accumulation is ordered.  The result, ``smax``, is the first slope of a
block's R-D hull: a block survives truncation at threshold ``t`` iff
``smax * band_gain >= t``, so blocks that fail are never fetched or coded.

Plain PyTorch (the JAX version is not a Pallas kernel).  Sums of squares
are float32 as in the JAX version; their reduction order differs, so
``smax`` agrees to float32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

#: bit-planes simulated: |int16| magnitudes need up to 16 (-32768).
PMAX = 16


def _nbr(sig: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """8-neighbour significance (frozen at plane start), clipped to the
    block interior like the native coder's row-mask shifts."""
    up = F.pad(sig[:, :-1, :], (0, 0, 1, 0))
    dn = F.pad(sig[:, 1:, :], (0, 0, 0, 1))
    t = up | sig | dn
    le = F.pad(t[:, :, :-1], (1, 0))
    ri = F.pad(t[:, :, 1:], (0, 1))
    return (le | ri | up | dn) & valid


def _sum2(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing (h, w) axes -> (K,); bools count as int32."""
    if x.dtype == torch.bool:
        return x.sum(dim=(1, 2), dtype=torch.int32)
    return x.sum(dim=(1, 2))


def bp_max_slope(tiles: torch.Tensor, th: torch.Tensor, tw: torch.Tensor,
                 stripe: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact bp-coder R-D accounting for a stack of code-blocks.

    ``tiles``: (K, cb, cb) integer coefficients (edge tiles zero-padded);
    ``th``/``tw``: (K,) true tile dims.  Returns ``(smax, d0)``: per block
    the maximum prefix slope (unweighted SSE per byte) and the total SSE
    at zero rate, both float32."""
    K, cb, _ = tiles.shape
    dev = tiles.device
    v = tiles.to(torch.int32)
    rows = torch.arange(cb, dtype=torch.int32, device=dev)
    valid = ((rows[None, :, None] < th[:, None, None]) &
             (rows[None, None, :] < tw[:, None, None]))
    # magnitudes <= 32768: int32 holds every bit-plane expression exactly
    mag = torch.where(valid, v.abs(), 0)
    magf = mag.to(torch.float32)
    d0 = _sum2(magf * magf)

    maxm = mag.amax(dim=(1, 2))
    msbs = torch.ceil(torch.log2(maxm.clamp(min=1).to(torch.float32) + 0.5)
                      ).to(torch.int32)
    msbs = torch.where(maxm > 0, msbs.clamp(min=1), 0)

    nstripes = (cb + stripe - 1) // stripe

    nbytes_list = []          # per pass: (K,) f32 byte counts (plane-gated)
    dsse_list = []            # per pass: (K,) f32 SSE deltas (plane-gated)

    for p in range(PMAX - 1, -1, -1):
        active = (p < msbs).to(torch.float32)            # (K,)
        bits = ((mag >> p) & 1).to(torch.bool)
        # significance entering plane p: some bit above p is set
        if p + 1 < 16:
            sig = (mag >> (p + 1)) != 0
        else:
            sig = torch.zeros_like(bits)
        nb = _nbr(sig, valid)

        # reconstruction gain of a coefficient becoming significant at
        # plane p: rec = ((m>>p)<<p) + (p>0 ? 1<<(p-1) : 0)
        rec = ((mag >> p) << p) + ((1 << (p - 1)) if p > 0 else 0)
        err = magf - rec.to(torch.float32)
        new_sq = err * err - magf * magf                  # <= 0

        ones_new = bits & ~sig                            # newly significant

        # ---- significance propagation: members = ~sig & nbr & valid
        mem = nb & ~sig
        ones_spp = ones_new & nb
        nbits = (_sum2(mem) + _sum2(ones_spp)).to(torch.float32)
        dsse = _sum2(torch.where(ones_spp, new_sq, 0.0))
        nbytes_list.append(torch.ceil(nbits / 8.0) * active)
        dsse_list.append(dsse * active)

        # ---- magnitude refinement: members = sig & valid
        nbits = _sum2(sig).to(torch.float32)
        if p > 0:
            r = (mag & ((1 << p) - 1)).to(torch.float32)
            b1 = bits & sig
            b0 = sig & ~bits
            h = float(1 << (p - 1))
            dsse = _sum2(torch.where(b1, h * h - 2.0 * h * r,
                                     torch.where(b0, 2.0 * h * r - 3.0 * h * h,
                                                 0.0)))
        else:
            dsse = -_sum2((sig & ~bits).to(torch.float32))
        nbytes_list.append(torch.ceil(nbits / 8.0) * active)
        dsse_list.append(dsse * active)

        # ---- cleanup: members = ~sig & ~nbr & valid, stripe group testing
        memc = (~sig) & (~nb) & valid
        ones_cp = ones_new & ~nb
        member_bits = memc.reshape(K, nstripes, stripe, cb).sum(
            dim=(2, 3), dtype=torch.int32)
        one_bits = ones_cp.reshape(K, nstripes, stripe, cb).sum(
            dim=(2, 3), dtype=torch.int32)
        nbits = torch.where(
            member_bits > 0,
            1 + torch.where(one_bits > 0, member_bits + one_bits, 0),
            0).sum(dim=1, dtype=torch.int32).to(torch.float32)
        dsse = _sum2(torch.where(ones_cp, new_sq, 0.0))
        nbytes_list.append(torch.ceil(nbits / 8.0) * active)
        dsse_list.append(dsse * active)

    # ordered prefix accumulation over the 3*PMAX tiny per-pass stats
    nbytes = torch.stack(nbytes_list)                     # (48, K)
    dsse = torch.stack(dsse_list)
    ends = torch.cumsum(nbytes, dim=0)
    sse = d0[None, :] + torch.cumsum(dsse, dim=0)
    slope = torch.where(ends > 0, (d0[None, :] - sse) / ends.clamp(min=1.0),
                        0.0)
    smax = slope.amax(dim=0)
    return smax, d0
