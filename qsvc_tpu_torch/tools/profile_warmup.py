"""Cold-start attribution of a fresh process at the flagship.

Port of the JAX package's ``tools/profile_warmup.py``, which splits the
cold compile of the encode's XLA programs.  XLA's persistent compile
cache has no counterpart here: the port has no program to compile but
its two native libraries, built once per checkout into
``qsvc_tpu_torch/_build/``, and its CUDA graphs, captured once per
process.  A fresh process's time before its first flagship frame is
split in the order it is paid:

1. ``import torch``, the CUDA context (one tiny tensor on the card,
   synchronised) and ``import qsvc_tpu_torch.api``, timed in a fresh
   child interpreter;
2. the build check and load of the kernels of ``csrc/`` (``nvcc``) and of
   the native coder (``g++``); with ``--cold`` both are built from
   scratch into a private temporary build directory (the checkout's
   ``_build/`` is never emptied), then loaded from it;
3. the input video (``synthetic_video`` of the flagship);
4. ``api.prewarm``: each captured program's eager warm-up and CUDA graph
   capture (``utils/graphs.py``, one line per key);
5. the first encode of the flagship's GOPs after it (``compress_gops``),
   with the graphs it still captured (none expected);
6. ``api.prewarm_decode`` with its programs' lines, and the first decode
   (``expand_gops``);
7. the PSNR of the decoded video (``video_psnr``, host numpy).

Run from the root of a checkout (one card; no CPU fallback):

    python3 -m qsvc_tpu_torch.tools.profile_warmup [--cold] [--out F]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from .. import api
from ..codec import fast
from ..config import CodecConfig
from ..io import synthetic_video, video_psnr
from ..ops import cuda_lib
from ..utils import graphs
from . import bench
from .profile import needs_card, swapped, sync, write_json

#: the child interpreter of step 1: prints one JSON line of seconds
_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
if sys.argv[1] == "cuda":
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
t2 = time.perf_counter()
import qsvc_tpu_torch.api
t3 = time.perf_counter()
print(json.dumps({"import_torch_s": t1 - t0, "cuda_context_s": t2 - t1,
                  "import_port_s": t3 - t2}))
"""
#: the checkout's root, the child's working directory
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _graph_lines(before: set) -> list:
    """The kept graphs captured since the key set ``before``: name,
    shapes, warm-up and capture seconds."""
    return [{"name": s["name"], "shapes": s["shapes"],
             "warmup_s": s["warmup_s"], "capture_s": s["capture_s"]}
            for s in graphs.stats()
            if (s["name"], str(s["shapes"])) not in before]


def _keys() -> set:
    return {(s["name"], str(s["shapes"])) for s in graphs.stats()}


def _builds(device, cold: bool) -> list:
    """Step 2's rows: build (or check) and load each native library."""
    cuda = torch.device(device).type == "cuda"
    if not cold:
        rows = [("build check + load: native coder (g++)",
                 fast.build_seconds())]
        if cuda:
            rows.insert(0, ("build check + load: csrc kernels (nvcc)",
                            cuda_lib.build_seconds()))
        return rows
    tmp = tempfile.mkdtemp(prefix="qsvc_build_")
    rows = []
    try:
        with swapped([(cuda_lib, "BUILD_DIR", tmp),
                      (fast, "SO_PATH", os.path.join(tmp, "libqsvc.so"))]):
            steps = [("build: native coder (g++)", fast._build),
                     ("load: native coder", fast.build_seconds)]
            if cuda:
                steps = [("build: csrc kernels (nvcc)", cuda_lib._build),
                         ("load: csrc kernels", cuda_lib.build_seconds)
                         ] + steps
            for label, fn in steps:
                t0 = time.perf_counter()
                fn()
                rows.append((label, time.perf_counter() - t0))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def profile_warmup(cfg: CodecConfig, video, device="cuda",
                   cold: bool = False) -> dict:
    """Steps 1-7 of the module docstring at ``cfg``; ``video`` is the
    function that makes the input video (timed as step 3).  Returns the
    JSON row: (step, seconds) rows in order and the graphs' lines."""
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, torch.device(device).type],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"the child interpreter failed:\n{proc.stderr}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = [("import torch (fresh interpreter)", child["import_torch_s"]),
            ("CUDA context (fresh interpreter)", child["cuda_context_s"]),
            ("import qsvc_tpu_torch.api (fresh interpreter)",
             child["import_port_s"])]
    rows += _builds(device, cold)

    def step(label, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(device)
        rows.append((label, time.perf_counter() - t0))
        return out

    vid = step("synthetic_video", video)
    before = _keys()
    step("api.prewarm", api.prewarm, cfg, reversible=False, device=device)
    encode_graphs = _graph_lines(before)
    before = _keys()
    streams = step("first compress_gops after the prewarm", api.compress_gops,
                   vid, cfg, reversible=False, device=device)
    late = _graph_lines(before)
    before = _keys()
    step("api.prewarm_decode", api.prewarm_decode, streams[0].cfg,
         reversible=False, delta=streams[0].delta or None, device=device)
    decode_graphs = _graph_lines(before)
    before = _keys()
    rec = step("first expand_gops after the prewarm", api.expand_gops,
               streams, device=device)
    late += _graph_lines(before)
    step("video_psnr", video_psnr, vid, rec)
    return {"device": bench.device_name(device), "cold": cold,
            "rows": [{"step": k, "seconds": s} for k, s in rows],
            "total_s": sum(s for _, s in rows),
            "encode_graphs": encode_graphs, "decode_graphs": decode_graphs,
            "graphs_after_prewarm": late}


def print_warmup(row: dict) -> None:
    print(f"profile_warmup [{row['device']}]: cold build {row['cold']}",
          flush=True)
    for r in row["rows"]:
        print(f"{r['step']:50s} {r['seconds']:9.6f} s", flush=True)
        if r["step"] in ("api.prewarm", "api.prewarm_decode"):
            key = ("encode_graphs" if r["step"] == "api.prewarm"
                   else "decode_graphs")
            for g in row[key]:
                print(f"    {g['name']} {g['shapes']}: warm-up "
                      f"{g['warmup_s']:.6f} s, capture {g['capture_s']:.6f} "
                      f"s", flush=True)
    print(f"{'TOTAL':50s} {row['total_s']:9.6f} s; graphs captured after "
          f"the prewarms: {len(row['graphs_after_prewarm'])}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cold", action="store_true",
                    help="build both libraries from scratch in a private "
                         "temporary directory")
    ap.add_argument("--out", default="", help="also write the row here")
    args = ap.parse_args(argv)
    if not needs_card("profile_warmup"):
        return 1
    cfg = CodecConfig(**bench.FLAGSHIP)
    row = profile_warmup(
        cfg, lambda: synthetic_video(cfg.pictures, cfg.pixels_in_y,
                                     cfg.pixels_in_x, seed=0),
        device="cuda", cold=args.cold)
    print_warmup(row)
    write_json(args.out, row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
