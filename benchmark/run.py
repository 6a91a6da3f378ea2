"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
are found by name (:mod:`.spec`).  This process imports neither torch nor
the program: it starts one rank process per card (:mod:`.rank`), each
bound to its share of the host's cores where the configuration's host
layout splits the host, with a rendezvous file and the ranks' results in
a fresh directory under ``TMPDIR``, waits for them, and prints one JSON
line as the last line of its standard output:

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown",] "compared"}

``metrics`` are the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones; ``compared`` holds each number that decided ``correct``
beside its limit, also printed as the last lines of standard error.

Exit codes: 0 with a result; 1 with a result whose run failed after its
window started (``correct`` false); 2 without a result (no card, too few
cards, a failure in set-up, or a forbidden module loaded).
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import List, Optional  # noqa: E402

from . import check  # noqa: E402
from . import spec as specs  # noqa: E402

#: seconds the ranks may take before they are stopped: the first run of a
#: cell in a checkout builds the kernels
RANKS_TIMEOUT_S = 1100
#: the program's kernel caches, at fixed paths inside the checkout
CACHE_DIR = os.path.join(specs.ROOT, ".bench_cache")


def host_split(cpus: List[int], ranks: int, split: bool
               ) -> List[Optional[List[int]]]:
    """Each rank's cpus where ``split``: disjoint equal runs of ``cpus`` in
    order, as a launcher that divides a host among its ranks gives them;
    None for every rank without ``split`` or with fewer cpus than ranks
    (the ranks inherit the host)."""
    per = len(cpus) // ranks
    if not split or per == 0:
        return [None] * ranks
    return [cpus[r * per:(r + 1) * per] for r in range(ranks)]


def rank_env(cores: Optional[List[int]]) -> dict:
    """A rank's environment: the caches inside the checkout, and with its
    own cores, as many OpenMP threads as it has cores."""
    env = dict(os.environ)
    env["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    if cores:
        env["OMP_NUM_THREADS"] = str(len(cores))
    return env


def launch(cell: specs.Cell, args, workdir: str, device: str = "cuda",
           fault: Optional[str] = None) -> List[dict]:
    """Start the cell's ranks, wait for them, and return their results
    (a rank that left none gets ``{"stage": "setup", "error": ...}``).
    When one fails, the others are stopped."""
    ranks = cell.chips
    split = bool((cell.config.get("host_layout") or {}).get("split_cores"))
    shares = host_split(sorted(os.sched_getaffinity(0)), ranks, split)
    for r, share in enumerate(shares):
        if share is not None:
            print(f"benchmark: rank {r} on cpus {share}", file=sys.stderr)
    procs, outs = [], []
    for r in range(ranks):
        out = os.path.join(workdir, f"rank{r}.json")
        spec = {"cell": cell.name, "rank": r, "world": ranks,
                "device": device, "seed": args.seed,
                "seconds": args.seconds, "trace": args.trace,
                "config": cell.config, "traffic": cell.traffic,
                "end_to_end": cell.end_to_end, "per_layer": cell.per_layer,
                "cores": shares[r], "store": os.path.join(workdir, "store"),
                "out": out, "process_start": PROCESS_START,
                "fault": fault}
        path = os.path.join(workdir, f"rank{r}.spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "benchmark.rank", path],
            cwd=specs.ROOT, env=rank_env(shares[r]),
            stdout=2, stderr=2))
    deadline = time.time() + RANKS_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.time() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    results = []
    for r, out in enumerate(outs):
        try:
            with open(out) as f:
                results.append(json.load(f))
        except (OSError, ValueError):
            results.append({"rank": r, "stage": "setup",
                            "error": f"rank {r} left no result (exit "
                                     f"{procs[r].returncode})"})
    return results


def result_line(cell: specs.Cell, results: List[dict], trace: bool,
                device: str) -> dict:
    """The run's result from its ranks' (rank 0 first)."""
    lead = results[0]
    ok = all(r.get("stage") == "done" and not r.get("error")
             for r in results)
    compared = lead.get("compared") or check.unmeasured()
    attempted = int(lead.get("attempted", 0))
    line = {"correct": bool(ok and lead.get("correct")),
            "attempted": attempted,
            # a run cut short after its window counts every answer failed
            "failed": int(lead["failed"]) if ok else attempted,
            "metrics": lead.get("metrics", {}),
            "device": {"platform": "gpu" if device == "cuda" else device,
                       "kind": lead.get("kind", ""),
                       "count": cell.chips,
                       "memory_peak_bytes": max(
                           int(r.get("memory_peak_bytes", 0))
                           for r in results)}}
    if trace:
        busy = [r["busy_s"] for r in results if "busy_s" in r]
        win = [r["window_s"] for r in results if "window_s" in r]
        if busy and win:
            line["device"]["busy_s"] = sum(busy) / len(busy)
            line["device"]["window_s"] = sum(win) / len(win)
        if "breakdown" in lead:
            line["breakdown"] = lead["breakdown"]
    line["compared"] = compared
    return line


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda", root: str = specs.ROOT,
         fault: Optional[str] = None) -> int:
    """The run; ``device``, ``root`` and ``fault`` are the tests' (the
    CPU, a checkout with small configurations, a broken program)."""
    args = parse(sys.argv[1:] if argv is None else argv)
    try:
        cell = specs.load_cell(args.workload, root)
    except (KeyError, OSError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    workdir = tempfile.mkdtemp(prefix="qsvc-bench-")
    try:
        results = launch(cell, args, workdir, device, fault)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for r in results:
        if r.get("traceback"):
            print(f"rank {r['rank']}:\n{r['traceback']}", file=sys.stderr)
    found = sorted({m for r in results
                    for m in r.get("forbidden_modules", [])})
    if found:
        print(f"benchmark: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 2
    failed_setup = [r for r in results if r.get("error")
                    and r.get("stage") == "setup"]
    if failed_setup:
        for r in failed_setup:
            print(f"benchmark: rank {r['rank']} failed in set-up: "
                  f"{r.get('detail') or r['error']}", file=sys.stderr)
        return 2
    line = result_line(cell, results, bool(args.trace), device)
    lead = results[0]
    for r in results:
        steps = ", ".join(f"{k} {v:.3f}" for k, v in
                          r.get("setup_steps", {}).items())
        print(f"benchmark: rank {r['rank']} set-up s: {steps}",
              file=sys.stderr)
    secs = sorted(lead.get("answer_seconds", []))
    if secs:
        q = statistics.quantiles(secs, n=4) if len(secs) > 1 else secs * 3
        print(f"benchmark: {len(secs)} answers, seconds min {secs[0]:.3f} "
              f"q1 {q[0]:.3f} median {q[1]:.3f} q3 {q[2]:.3f} max "
              f"{secs[-1]:.3f}; in order: "
              + " ".join(f"{a:.3f}" for a in lead["answer_seconds"]),
              file=sys.stderr)
    print(f"benchmark: {cell.name} seed {args.seed}: "
          f"{lead.get('compared_answers', 0)} answers compared, reference "
          f"{lead.get('reference_s', 0.0):.1f} s", file=sys.stderr)
    check.print_compared(line["compared"])
    print(json.dumps(line), flush=True)
    return 0 if all(r.get("stage") == "done" for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
