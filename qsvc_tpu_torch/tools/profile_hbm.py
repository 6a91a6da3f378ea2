"""Memory-bandwidth rows on the card: what the kernels' bounds assume.

Port of the JAX package's ``tools/profile_hbm.py``, its 8 rows: the
elementwise ``a * 2 + 1`` over 1 GiB of float32 and 2^28 bfloat16 and
int16 elements, over a 256 MB float32 matrix, its row sums and its total
sum, a chain of 10 int32 adds over 17 flagship lumas, and the bp R-D
simulation's bit-plane pattern (4 planes of 13,000 64x64 tiles; int16,
for torch has no shift of uint16).  The bytes of a row are what its
function must move (each input read once, each output written once), as
in the JAX tool.  XLA fused each row into one kernel; eager PyTorch runs
``a * 2 + 1`` as two kernels, the chain of adds as 10 and the bit-plane
pattern as several per plane, each reading and writing whole tensors,
so those rows move more than they are credited with.  Two rows of one
kernel each follow: the stream copy (``b.copy_(a)``) and scale
(``torch.mul(a, 2.0, out=b)``) over the 1 GiB of float32.

Each row is timed with CUDA events over many launches after a warm-up,
and printed with its GB/s and its share of the H100's published 3.35
TB/s (the rate ``chip_smoke.py``'s bounds take); the stream rate is the
better of the copy and the scale.

Run from the root of a checkout (one card; no CPU fallback):

    python3 -m qsvc_tpu_torch.tools.profile_hbm [--out F]
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import bench
from .profile import needs_card, write_json

#: the published HBM3 rate of one H100 SXM, bytes per second
HBM_BYTES_PER_S = 3.35e12
#: the labels of the stream rows (one kernel: read once, write once)
STREAM_ROWS = ("stream copy f32", "stream scale f32")


def _simlike(m: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(m.shape[0], dtype=torch.float32, device=m.device)
    for p in range(4):
        bits = ((m >> p) & 1).to(torch.bool)
        acc += bits.sum(dim=(1, 2)).to(torch.float32)
    return acc


def rows(device, n: int = 1 << 28, side: int = 8192,
         frame=(17, 1088, 1920), tiles: int = 13000) -> list:
    """The JAX tool's 8 rows at its sizes (smaller ones for a test), then
    the two stream rows: (label, function, input, bytes moved)."""
    a32 = torch.ones(n, dtype=torch.float32, device=device)
    a16 = torch.ones(n, dtype=torch.bfloat16, device=device)
    i16 = torch.ones(n, dtype=torch.int16, device=device)
    b = torch.ones((side, side), dtype=torch.float32, device=device)
    c = torch.ones(frame, dtype=torch.int32, device=device)
    d = torch.ones((tiles, 64, 64), dtype=torch.int16, device=device)
    out32 = torch.empty_like(a32)
    nb = b.numel() * 4
    return [
        (f"1D f32 a*2+1 ({a32.numel() * 4 / 2**30:g} GiB)",
         lambda x: x * 2.0 + 1.0, a32, 2 * a32.numel() * 4),
        (f"1D bf16 a*2+1 ({a16.numel() * 2 / 2**30:g} GiB)",
         lambda x: x * 2.0 + 1.0, a16, 2 * a16.numel() * 2),
        ("1D i16 a*2+1", lambda x: x * 2 + 1, i16, 2 * i16.numel() * 2),
        (f"2D f32 a*2+1 ({nb / 1e6:g} MB)", lambda x: x * 2.0 + 1.0, b,
         2 * nb),
        ("2D f32 sum-rows", lambda x: x.sum(dim=1), b, nb),
        ("2D f32 sum-all", lambda x: x.sum(), b, nb),
        (f"{frame[0]}x{frame[1]}x{frame[2]} i32 chain of 10 adds",
         lambda x: x + 1 + 2 + 3 + 4 + 5 + 6 + 7 + 8 + 9 + 10, c,
         2 * c.numel() * 4),
        (f"sim-like 4 planes over {tiles} tiles i16", _simlike, d,
         4 * d.numel() * 2),
        (STREAM_ROWS[0], lambda x: out32.copy_(x), a32, 2 * a32.numel() * 4),
        (STREAM_ROWS[1], lambda x: torch.mul(x, 2.0, out=out32), a32,
         2 * a32.numel() * 4),
    ]


def _event_ms(fn, x, iters: int) -> float:
    """Milliseconds per call of ``fn(x)`` on the card: CUDA events around
    ``iters`` calls, after two warm-up calls."""
    for _ in range(2):
        fn(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_hbm(device="cuda", iters: int = 20) -> dict:
    """The rows on ``device`` (a card): ms per call, GB/s and the share
    of :data:`HBM_BYTES_PER_S`, and the stream rate."""
    out = []
    for label, fn, x, nbytes in rows(device):
        ms = _event_ms(fn, x, iters)
        rate = nbytes / (ms * 1e-3)
        out.append({"label": label, "ms": ms, "bytes": nbytes,
                    "gb_s": rate / 1e9, "share": rate / HBM_BYTES_PER_S})
    stream = max(r["gb_s"] for r in out if r["label"] in STREAM_ROWS)
    return {"device": bench.device_name(device), "iters": iters,
            "rows": out, "stream_gb_s": stream,
            "stream_share": stream * 1e9 / HBM_BYTES_PER_S}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the row here")
    args = ap.parse_args(argv)
    if not needs_card("profile_hbm"):
        return 1
    row = profile_hbm("cuda")
    print(f"profile_hbm [{row['device']}]: CUDA events, {row['iters']} "
          f"launches a row after 2 warm-ups", flush=True)
    for r in row["rows"]:
        print(f"{r['label']:44s} {r['ms']:9.4f} ms  {r['gb_s']:8.1f} GB/s "
              f" {r['share']:.4f} of 3.35 TB/s", flush=True)
    print(f"stream rate (the better of copy and scale): "
          f"{row['stream_gb_s']:.1f} GB/s = {row['stream_share']:.4f} of "
          f"3.35 TB/s", flush=True)
    write_json(args.out, row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
