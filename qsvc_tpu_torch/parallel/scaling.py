"""Scaling sweep of the sharded encode step: fps on one rank against n
ranks, written to one JSON file.

    python -m qsvc_tpu_torch.parallel.scaling --ns 1,4 --reps 3 \\
        --device cuda --out scaling.json

Each point is :func:`.distributed.scaling_point`: ``n`` spawned worker
processes, one process group of their own (``nccl`` with one card per
rank on ``cuda``, ``gloo`` on ``cpu``), one GOP of the configuration per
rank (by default :data:`.distributed.SCALING_CONFIG`: 512x512, TRLs 3,
block 32, search 4, update 1/4, SRLs 4).  The n = 1 point is the
baseline of every efficiency (:func:`.distributed.efficiency`).  With
``cuda`` the file records each card's name and power limit as
``nvidia-smi`` reads them; more ranks than cards raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

from . import distributed


def cards() -> list:
    """Each card's name and power limit, as ``nvidia-smi`` reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ns", default="1,2", help="rank counts, e.g. 1,4")
    ap.add_argument("--reps", type=int, default=distributed.SCALING_REPS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    ns = sorted({int(x) for x in args.ns.split(",")} | {1})
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scaling: no CUDA device", file=sys.stderr)
        return 1
    cfg = distributed.SCALING_CONFIG
    points = {}
    for n in ns:
        points[n] = distributed.scaling_point(n, args.reps, cfg,
                                              device=args.device)
        points[n]["efficiency"] = distributed.efficiency(points[n],
                                                         points[1])
        print(json.dumps(points[n]), flush=True)
    result = {
        "config": dataclasses.asdict(cfg),
        "step": "parallel.transform.encode_step_sharded, one GOP per rank",
        "device": args.device,
        "cards": cards() if args.device == "cuda" else None,
        "host_cores": os.cpu_count(),
        "reps": args.reps,
        "points": [points[n] for n in ns],
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
