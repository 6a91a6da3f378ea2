"""The bit-parallel ("bp") code-block coder, written as plain tensor code.

The program codes its blocks in C++ (``qsvc_tpu_torch/native/ebcot.cpp``,
``bp::encode_block``); this is the same stream format written from its
description, over many blocks at once:

* for each bit plane ``p`` from ``msbs - 1`` down to 0, three passes,
  each byte-aligned, bits packed least significant first:

  - significance propagation: the members are the coefficients not yet
    significant with a significant one among their 8 neighbours (the
    significance frozen at the start of the plane); their bits in raster
    order, then the signs of those whose bit is 1;
  - magnitude refinement: the significant coefficients' bits, raw;
  - cleanup: the rest, per stripe of 4 rows that has a member: one bit
    saying whether any member's bit is 1, and if so the members' bits and
    then the signs of the ones;

* significance is updated at the end of the plane only;
* after each pass the squared error of the reconstruction (midpoint of
  the known bits) is recorded; after each plane, with a ``min_slope``,
  the coder stops when the last plane's distortion drop per byte falls
  below it.

Every distortion is a whole number, kept in int64, so the sums are exact
whatever their order.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F


class BlockCode(NamedTuple):
    """One coded block: bytes, magnitude bit planes, the byte offset at
    the end of each pass, the squared error after each pass and before
    any (all whole numbers, as floats)."""
    data: bytes
    msbs: int
    pass_ends: List[int]
    pass_dist: List[float]
    dist0: float


def _neighbours(sig: torch.Tensor) -> torch.Tensor:
    """(K, H, W) bool: some of the 8 neighbours (not the centre) is set;
    outside the block counts as unset."""
    s = F.pad(sig.to(torch.uint8), (1, 1, 1, 1))
    H, W = sig.shape[-2:]
    out = torch.zeros_like(sig)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            out |= s[:, dy:dy + H, dx:dx + W].bool()
    return out


def _pack(include: torch.Tensor, values: torch.Tensor):
    """Each row's ``values`` where ``include``, in order, packed into bytes
    least significant bit first: (host uint8 rows, host byte counts)."""
    k, n = include.shape
    count = include.sum(dim=1)
    nbits = int(count.max()) if k else 0
    nbytes = (count + 7) // 8
    width = max(-(-nbits // 8), 1) * 8
    buf = torch.zeros((k, width + 1), dtype=torch.int64,
                      device=include.device)
    pos = torch.cumsum(include.to(torch.int64), dim=1) - 1
    # excluded slots all land in the spare last column
    pos = torch.where(include, pos, width)
    buf.scatter_(1, pos, values.to(torch.int64) * include)
    weights = (1 << torch.arange(8, device=include.device))
    packed = (buf[:, :width].view(k, width // 8, 8) * weights).sum(-1)
    return (packed.to(torch.uint8).cpu().numpy(), nbytes.cpu().numpy())


def encode_blocks(tiles: torch.Tensor, th: Sequence[int], tw: Sequence[int],
                  min_slopes: Sequence[float]) -> List[BlockCode]:
    """Code ``tiles`` (K, cb, cb), integer, zero outside each block's
    (th, tw) top-left corner, cb <= 64; ``min_slopes`` per block, 0 for
    no early stop."""
    K, H, W = tiles.shape
    dev = tiles.device
    if K == 0:
        return []
    v = tiles.to(torch.int64)
    mag = v.abs()
    neg = v < 0
    th_t = torch.as_tensor(list(th), device=dev)
    tw_t = torch.as_tensor(list(tw), device=dev)
    valid = ((torch.arange(H, device=dev)[None, :, None] < th_t[:, None, None])
             & (torch.arange(W, device=dev)[None, None, :]
                < tw_t[:, None, None]))
    mag = torch.where(valid, mag, 0)
    maxm = mag.amax(dim=(1, 2))
    msbs = torch.zeros(K, dtype=torch.int64, device=dev)
    for b in range(63):
        msbs += (maxm >> b) > 0
    dist0 = (mag * mag).sum(dim=(1, 2))
    sse = dist0.clone()
    sig = torch.zeros_like(valid)
    ms = [float(x) for x in min_slopes]
    stopped_h = [False] * K
    stopped = torch.zeros(K, dtype=torch.bool, device=dev)
    Hs = -(-H // 4) * 4                       # rows padded to whole stripes

    msbs_h = msbs.cpu().tolist()
    chunks: List[List[bytes]] = [[] for _ in range(K)]
    ends: List[List[int]] = [[] for _ in range(K)]
    dists: List[List[float]] = [[] for _ in range(K)]
    total = [0] * K

    def record(idx_h, packed, nbytes, sse_sel):
        sse_h = sse_sel.cpu().tolist()
        for i, b in enumerate(idx_h):
            n = int(nbytes[i])
            if n:
                chunks[b].append(packed[i, :n].tobytes())
                total[b] += n
            ends[b].append(total[b])
            dists[b].append(float(sse_h[i]))

    for p in range(max(msbs_h) - 1, -1, -1):
        act = (~stopped) & (msbs > p)
        idx = act.nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        idx_h = idx.cpu().tolist()
        k = len(idx_h)
        m, s, val, sg = mag[idx], sig[idx], valid[idx], neg[idx]
        bits = ((m >> p) & 1).bool() & val
        nbr = _neighbours(s)
        half = (1 << (p - 1)) if p > 0 else 0
        rec_new = ((m >> p) << p) + half

        def newly_delta(ones):
            e = m - rec_new
            return torch.where(ones, e * e - m * m, 0).sum(dim=(1, 2))

        # significance propagation
        mem = ~s & nbr & val
        ones = bits & mem
        packed, nbytes = _pack(
            torch.cat([mem.view(k, -1), ones.view(k, -1)], dim=1),
            torch.cat([bits.view(k, -1), sg.view(k, -1)], dim=1))
        sse[idx] += newly_delta(ones)
        record(idx_h, packed, nbytes, sse[idx])

        # magnitude refinement
        mem = s & val
        packed, nbytes = _pack(mem.view(k, -1), bits.view(k, -1))
        rec_old = ((m >> (p + 1)) << (p + 1)) + (1 << p)
        e_old, e_new = m - rec_old, m - rec_new
        sse[idx] += torch.where(mem, e_new * e_new - e_old * e_old,
                                0).sum(dim=(1, 2))
        record(idx_h, packed, nbytes, sse[idx])

        # cleanup, by stripes of 4 rows
        mem = ~s & ~nbr & val
        ones = bits & mem

        def stripes(x):
            x = F.pad(x.to(torch.uint8), (0, 0, 0, Hs - H)).bool()
            return x.view(k, Hs // 4, 4 * W)
        mem_s, ones_s = stripes(mem), stripes(ones)
        any_mem = mem_s.any(dim=2, keepdim=True)
        any_one = ones_s.any(dim=2, keepdim=True)
        include = torch.cat([any_mem, mem_s & any_one, ones_s & any_one],
                            dim=2)
        values = torch.cat([any_one, stripes(bits), stripes(sg)], dim=2)
        packed, nbytes = _pack(include.view(k, -1), values.view(k, -1))
        sse[idx] += newly_delta(ones)
        record(idx_h, packed, nbytes, sse[idx])

        sig[idx] = s | bits
        # early stop: the plane's distortion drop per byte under min_slope
        for b in idx_h:
            n = len(ends[b])
            if ms[b] > 0 and n >= 4:
                dD = dists[b][n - 4] - dists[b][n - 1]
                dR = float(ends[b][n - 1] - ends[b][n - 4])
                if dR > 0 and dD / dR < ms[b]:
                    stopped_h[b] = True
        stopped = torch.as_tensor(stopped_h, device=dev)

    dist0_h = dist0.cpu().tolist()
    return [BlockCode(b"".join(chunks[b]), int(msbs_h[b]), ends[b],
                      dists[b], float(dist0_h[b])) for b in range(K)]


def decode_blocks(blocks: Sequence, cb: int, device,
                  chunk: int = 2048) -> torch.Tensor:
    """Decode coded blocks back to their coefficients: (K, cb, cb) int64,
    signed, each coefficient at the midpoint of its known bits (the
    reconstruction the coder's distortions assume), zero where nothing is
    known.  ``blocks`` are (msbs, pass lengths in bytes, data, (th, tw)).
    Bits read past a block's data read 0, so a damaged block decodes to
    something rather than failing."""
    out = [_decode_chunk(blocks[i:i + chunk], cb, torch.device(device))
           for i in range(0, len(blocks), chunk)]
    if not out:
        return torch.zeros((0, cb, cb), dtype=torch.int64, device=device)
    return torch.cat(out)


def _decode_chunk(blocks, cb: int, dev) -> torch.Tensor:
    K, H, W = len(blocks), cb, cb
    flat, base, lim = [], [], []
    off = 0
    for _m, _lens, data, _shape in blocks:
        flat.append(bytes(data) + b"\0")     # a zero byte past the end
        base.append(8 * off)
        lim.append(8 * len(data))
        off += len(data) + 1
    raw = np.frombuffer(b"".join(flat), dtype=np.uint8)
    bits = torch.from_numpy(np.unpackbits(raw, bitorder="little")
                            .astype(np.bool_)).to(dev)
    base_t = torch.tensor(base, dtype=torch.int64, device=dev)
    lim_t = torch.tensor(lim, dtype=torch.int64, device=dev)
    npass_max = max(len(b[1]) for b in blocks)
    starts = np.zeros((K, max(npass_max, 1)), np.int64)
    for k, (_m, lens, _d, _s) in enumerate(blocks):
        if lens:
            starts[k, 1:len(lens)] = 8 * np.cumsum(lens[:-1])
    starts_t = torch.from_numpy(starts).to(dev)
    npass = torch.tensor([len(b[1]) for b in blocks], device=dev)
    msbs = torch.tensor([int(b[0]) for b in blocks], device=dev)
    th = torch.tensor([b[3][0] for b in blocks], device=dev)
    tw = torch.tensor([b[3][1] for b in blocks], device=dev)
    valid = ((torch.arange(H, device=dev)[None, :, None] < th[:, None, None])
             & (torch.arange(W, device=dev)[None, None, :]
                < tw[:, None, None]))
    mag = torch.zeros((K, H, W), dtype=torch.int64, device=dev)
    low = torch.zeros_like(mag)             # lowest plane known
    sig = torch.zeros_like(valid)
    neg = torch.zeros_like(valid)
    Hs = -(-H // 4) * 4

    def read(idx, pos):
        """The bits at ``pos`` (k, n) of blocks ``idx``, 0 past the end."""
        p = torch.minimum(pos.clamp(min=0), lim_t[idx][:, None])
        return bits[base_t[idx][:, None] + p]

    def rank(mask):
        return torch.cumsum(mask.to(torch.int64), dim=1) - 1

    def active(p, kind):
        j = 3 * (msbs - 1 - p) + kind
        act = (msbs > p) & (j < npass)
        idx = act.nonzero().squeeze(1)
        if idx.numel() == 0:
            return None, None
        return idx, starts_t[idx, j[idx]]

    top = int(msbs.max()) if K else 0
    for p in range(top - 1, -1, -1):
        plane = (msbs > p).nonzero().squeeze(1)
        if plane.numel() == 0:
            continue
        s0 = sig.clone()                    # frozen for the plane
        nbr0 = _neighbours(s0)
        gained = torch.zeros_like(sig)

        def settle(idx, ones, signs):
            o = ones.reshape(-1, H, W)
            mag[idx] |= o.to(torch.int64) << p
            low[idx] = torch.where(o, p, low[idx])
            neg[idx] = torch.where(o, signs.reshape(-1, H, W), neg[idx])
            gained[idx] |= o

        # significance propagation
        idx, start = active(p, 0)
        if idx is not None:
            mem = (~s0[idx] & nbr0[idx] & valid[idx]).view(len(idx), -1)
            ones = read(idx, start[:, None] + rank(mem)) & mem
            nmem = mem.sum(dim=1, keepdim=True)
            signs = read(idx, start[:, None] + nmem + rank(ones)) & ones
            settle(idx, ones, signs)
        # magnitude refinement
        idx, start = active(p, 1)
        if idx is not None:
            mem = (s0[idx] & valid[idx]).view(len(idx), -1)
            b = read(idx, start[:, None] + rank(mem)) & mem
            mag[idx] |= b.view(-1, H, W).to(torch.int64) << p
            low[idx] = torch.where(mem.view(-1, H, W), p, low[idx])
        # cleanup, stripe by stripe
        idx, start = active(p, 2)
        if idx is not None:
            k = len(idx)
            mem = ~s0[idx] & ~nbr0[idx] & valid[idx]
            mem_s = F.pad(mem.to(torch.uint8), (0, 0, 0, Hs - H)).bool() \
                .view(k, Hs // 4, 4 * W)
            ones_s = torch.zeros_like(mem_s)
            signs_s = torch.zeros_like(mem_s)
            pos = start.clone()
            for j in range(Hs // 4):
                m = mem_s[:, j]
                any_m = m.any(dim=1)
                flag = read(idx, pos[:, None])[:, 0] & any_m
                pos = pos + any_m
                b = read(idx, pos[:, None] + rank(m)) & m & flag[:, None]
                pos = pos + torch.where(flag, m.sum(dim=1), 0)
                sg = read(idx, pos[:, None] + rank(b)) & b
                pos = pos + b.sum(dim=1)
                ones_s[:, j], signs_s[:, j] = b, sg
            settle(idx, ones_s.view(k, Hs, W)[:, :H],
                   signs_s.view(k, Hs, W)[:, :H])
        sig |= gained

    half = torch.where(low > 0, torch.bitwise_left_shift(
        torch.ones_like(low), (low - 1).clamp(min=0)), 0)
    rec = torch.where(sig, mag + half, 0)
    return torch.where(neg, -rec, rec)
