"""The readings the limits of :mod:`.check` were set from, at a cell's own
size, many seeds in one process:

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 \\
        [--out file.json]

The control is the reference put in the program's place with its 9/7
transform and quantization in bfloat16, the precision below the
configuration's float32: it encodes every item a run with the seed is
fed, and its streams are judged by :func:`.check.compare_streams` as a
run judges the program's.  Each seed's row gives the compared numbers;
the control has to read one of them above its limit on every seed.  The
program's readings are the runs' own.  ``--dtype float64`` reads the
reference with its 9/7 in float64 in the program's place instead: a
stream that orders and rounds the float arithmetic otherwise, which the
limits have to pass.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(cell, seed, dev, dtype: str = "bfloat16") -> dict:
    import torch

    from . import check
    from . import spec as specs
    from .drive import Context
    from .records import Answer
    from .reference import encode as reference
    from .reference.config import CodecConfig
    entry = specs.module("entries", cell.traffic["entry"])
    codec, traffic = cell.config["codec"], cell.traffic
    ctx = Context({"config": cell.config, "traffic": traffic}, dev,
                  lambda name: None)
    frames = ctx.frames(entry.frame_count(codec, traffic),
                        codec["pixels_in_y"], codec["pixels_in_x"])
    pieces = entry.pieces(codec, traffic, frames, seed)
    rcfg = CodecConfig(**codec)
    t0 = time.time()
    keys = list(pieces)
    got = {i: reference.encode(*pieces[k], rcfg, dev,
                               getattr(torch, dtype))
           for i, k in enumerate(keys)}
    compared, failed = check.compare_streams(
        [Answer(k, 0.0) for k in keys], got, pieces,
        lambda p: reference.encode(*p, rcfg, dev, truth=True), dev)
    return {"seed": seed, "dtype": dtype, "answers": len(keys),
            "failed": failed,
            "bytes": [len(got[i]) for i in range(len(keys))],
            "seconds": time.time() - t0,
            **{k: v["value"] for k, v in compared.items()}}


def main(argv=None, device: str = "cuda", root: str = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float64"))
    ap.add_argument("--out", default="")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from . import spec as specs
    root = root or specs.ROOT
    cell = specs.load_cell(args.workload, root)
    if device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(device)
    rows = []
    for s in (int(x) for x in args.seeds.split(",") if x):
        rows.append(readings(cell, s, dev, args.dtype))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
