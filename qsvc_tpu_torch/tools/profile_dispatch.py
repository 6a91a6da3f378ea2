"""Kernel launch latency on the card, eager and replayed from a graph.

Port of the JAX package's ``tools/profile_dispatch.py``, in its card
meaning: a chain of 1, 10 and 100 tiny kernels (``a + 1`` on a 256x256
float32 tensor), each its own launch (eager) and replayed from one CUDA
graph that holds the whole chain; then chains of 1, 10 and 30 of the
flagship-sized op (``a * 2 + 1`` on 17x1088x1920 int32, two kernels
eager), eager and replayed.  Each time is host clock from the first
launch to the synchronise after the last, the median of several runs
after a warm-up, and is printed per op of the chain.  These explain the
decode's host launches (PERF.md: 1,668 per 4-GOP decode since the
captured programs) against the encode's 28.

Run from the root of a checkout (one card; no CPU fallback):

    python3 -m qsvc_tpu_torch.tools.profile_dispatch [--out F]
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import bench
from .profile import median_seconds, needs_card, write_json


def _chain(fn, x, n):
    for _ in range(n):
        x = fn(x)
    return x


def _graphed(fn, x, n):
    """A replay of one CUDA graph of ``n`` chained calls of ``fn``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _chain(fn, x, n)                            # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _chain(fn, x, n)
    return graph.replay


def profile_dispatch(device="cuda", reps: int = 9) -> dict:
    """The chains on ``device`` (a card), eager and replayed: seconds
    (median) per chain and per op."""
    tiny = torch.ones((256, 256), dtype=torch.float32, device=device)
    big = torch.ones((17, 1088, 1920), dtype=torch.int32, device=device)
    cases = [("tiny a+1 (256x256 f32)", lambda a: a + 1, tiny,
              (1, 10, 100)),
             ("a*2+1 (17x1088x1920 i32)", lambda a: a * 2 + 1, big,
              (1, 10, 30))]
    rows = []
    for label, fn, x, lengths in cases:
        for n in lengths:
            for mode in ("eager", "graph"):
                run = ((lambda fn=fn, x=x, n=n: _chain(fn, x, n))
                       if mode == "eager" else _graphed(fn, x, n))
                s = median_seconds(run, reps)[0]
                rows.append({"op": label, "chain": n, "mode": mode,
                             "seconds": s, "per_op_ms": s / n * 1e3})
    return {"device": bench.device_name(device), "reps": reps, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the row here")
    args = ap.parse_args(argv)
    if not needs_card("profile_dispatch"):
        return 1
    row = profile_dispatch("cuda")
    print(f"profile_dispatch [{row['device']}]: median of {row['reps']}",
          flush=True)
    for r in row["rows"]:
        print(f"chain of {r['chain']:4d} {r['op']:26s} {r['mode']:5s}: "
              f"{r['seconds'] * 1e3:9.4f} ms ({r['per_op_ms']:.4f} ms/op)",
              flush=True)
    write_json(args.out, row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
