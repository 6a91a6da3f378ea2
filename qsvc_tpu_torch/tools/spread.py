"""The run-to-run spread of the two benches, each run in a fresh process.

Runs ``python3 -m qsvc_tpu_torch.tools.bench`` and
``python3 -m qsvc_tpu_torch.tools.bench_decode`` in turns, ``--runs``
times each, every run a new process (so each pays its own start, kernel
load, prewarms and warm-ups, as a user's run does), and prints one JSON
object: each run's row, its process wall seconds and the seconds outside
its timed windows (start, kernel load, video, prewarms, warm-ups, PSNR),
and for every fps key each run's number, the median, the min and max and
(max - min) / median.
The bench's bpp and PSNR must be the same in every run (same
configuration, video and card); the object says whether they were.
Exits 1, after printing, if a run failed or they were not.

Run from the root of a checkout (one card):

    python3 -m qsvc_tpu_torch.tools.spread [--runs 5] [--out F]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

#: the fps keys of each bench's row whose spread is reported
FPS_KEYS = {
    "bench": ("value", "detail.decode_fps", "detail.e2e_fps",
              "detail.decode_e2e_fps"),
    "bench_decode": ("value", "detail.e2e_fps"),
}
#: the bench's quality keys, the same in every run
QUALITY_KEYS = ("detail.bpp", "detail.psnr_y", "detail.psnr_u",
                "detail.psnr_v")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _get(row: dict, key: str):
    for part in key.split("."):
        row = row[part]
    return row


def run_once(name: str, timeout: float = 600.0) -> tuple:
    """Run ``qsvc_tpu_torch.tools.<name>`` in a new process from the root
    of this checkout: ``(exit code, its last line parsed as JSON or None,
    wall seconds, stdout, stderr)``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           f"qsvc_tpu_torch.tools.{name}"], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    row = None
    if proc.returncode == 0 and lines and lines[-1].startswith("{"):
        row = json.loads(lines[-1])
    return proc.returncode, row, wall, proc.stdout, proc.stderr


def timed_seconds(row: dict) -> float:
    """The seconds of a bench row's timed windows: the staged and end to
    end encode (``bench``) and decode (both)."""
    d, n = row["detail"], row["detail"]["frames"]
    if "decode_fps" in d:                       # bench
        return (d["seconds"] + n / d["e2e_fps"] + n / d["decode_fps"]
                + n / d["decode_e2e_fps"])
    return d["seconds"] + d["e2e_seconds"]      # bench_decode


def stats(values: list) -> dict:
    """Each value, the median, min, max and (max - min) / median."""
    med = statistics.median(values)
    return {"runs": values, "median": med, "min": min(values),
            "max": max(values), "spread": (max(values) - min(values)) / med}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    runs = {name: [] for name in FPS_KEYS}
    failed = []
    for i in range(args.runs):
        for name in FPS_KEYS:
            rc, row, wall, out, err = run_once(name)
            tail = "\n".join(out.strip().splitlines()[-2:])
            print(f"{name} run {i + 1}: exit {rc}, {wall:.3f} s\n{tail}",
                  flush=True)
            if row is None:
                failed.append(f"{name} run {i + 1}: exit {rc}: {err[-2000:]}")
                continue
            runs[name].append({"row": row, "wall_seconds": wall,
                               "untimed_seconds": wall - timed_seconds(row)})
    result = {"runs": runs, "failed": failed, "spread": {}}
    for name, keys in FPS_KEYS.items():
        if not runs[name]:
            continue
        s = {k: stats([_get(r["row"], k) for r in runs[name]]) for k in keys}
        for k in ("wall_seconds", "untimed_seconds"):
            s[k] = stats([r[k] for r in runs[name]])
        result["spread"][name] = s
    quality = {tuple(_get(r["row"], k) for k in QUALITY_KEYS)
               for r in runs["bench"]}
    result["quality_same"] = len(quality) == 1
    result["quality"] = [dict(zip(QUALITY_KEYS, q)) for q in sorted(quality)]
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(text, flush=True)
    return 0 if not failed and result["quality_same"] else 1


if __name__ == "__main__":
    sys.exit(main())
