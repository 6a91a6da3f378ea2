"""One rank of a run: ``python3 -m benchmark.rank <spec.json>``.

The launcher (:mod:`.run`) writes the spec: the cell's configuration and
traffic, the seed, the window's length, whether to trace, this rank's
place in the group, its cores, the rendezvous file and where to write its
result.  The rank binds itself to its cores, then:

1. set-up: ``import torch``, the card check, the program, and the mix's
   entry's ``setup`` (``entries/<entry>.py``: the frames made on the card,
   the prewarm, the warm-up answers);
2. the window: the entry's ``drive``, with the program's spans recorded
   and the profiler on over part of it in a traced run;
3. the peak of device memory and the metrics of the cell that this
   rank's records hold;
4. on rank 0, with the program's graphs freed: the entry's ``judge``,
   the reference's comparison that decides ``correct``.

The result is one JSON file.  A failure before the window is reported as
``stage: "setup"``; after it as ``stage: "window"``.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
import traceback

#: top-level module names the port must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "qsvc_tpu")


def forbidden_modules():
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _write(path: str, out: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, path)


def run_rank(spec: dict, out: dict) -> None:
    steps = out.setdefault("setup_steps", {})
    mark = [time.time()]

    def step(name):
        now = time.time()
        steps[name] = now - mark[0]
        mark[0] = now

    steps["launch"] = mark[0] - spec["process_start"]
    import torch
    step("import_torch")

    from . import check, drive, records
    from . import spec as specs
    from .timeline import busy_seconds, labelled_gaps, top_ops

    rank, world = spec["rank"], spec["world"]
    cuda = spec["device"] == "cuda"
    if cuda:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            out.update(error="no_device",
                       detail=f"{world} CUDA device(s) needed, {have} seen")
            return
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")

    from qsvc_tpu_torch.utils import graphs, trace
    traffic = spec["traffic"]
    entry = specs.module("entries", traffic["entry"])
    step("import_program")

    ctx = drive.Context(spec, dev, step)
    state = entry.setup(ctx)
    tracer = drive.TraceWindow(bool(spec["trace"]),
                               float(traffic["trace_from"]),
                               float(traffic["trace_length"]))
    run = records.Run(spec["cell"], spec["config"], traffic,
                      float(spec["seconds"]))

    def on_start(t):
        run.window_start = t

    if spec["trace"]:
        drive.warm_profiler()       # CUPTI starts slowly the first time
        step("profiler")
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    # -- the window -------------------------------------------------------
    out["stage"] = "window"
    _write(spec["out"], out)        # a rank stopped from here on left this
    log = trace.RunLog() if spec["trace"] else None
    trace.set_run_log(log)
    try:
        answers, outputs = entry.drive(ctx, state, tracer, on_start)
    finally:
        trace.set_run_log(None)
    if cuda:
        torch.cuda.synchronize(dev)
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        out["kind"] = torch.cuda.get_device_name(dev)
    else:
        out["memory_peak_bytes"] = 0
        out["kind"] = "cpu"
    run.trace = tracer.result()
    run.answers = answers
    run.spans = log.records if log is not None else []
    run.setup_s = run.window_start - spec["process_start"]

    # -- what the window produced --------------------------------------------
    metrics = (spec["per_layer"] if spec["trace"] else spec["end_to_end"])
    out["metrics"] = specs.read_metrics(metrics, run)
    out["window_start"] = run.window_start
    out["attempted"] = len(answers)
    out["answer_seconds"] = [a.t_done - a.t_taken for a in answers
                             if a.t_done is not None]
    if run.trace is not None:
        tr = run.trace
        out["busy_s"] = busy_seconds(tr.ops, tr.start, tr.end)
        out["window_s"] = tr.end - tr.start
        out["breakdown"] = {
            "device_ops": top_ops(tr.ops, tr.start, tr.end, 10),
            "idle_gaps": labelled_gaps(tr.ops, run.spans, tr.start,
                                       tr.end, 10)}

    # -- the reference, on rank 0, with the program's state freed ---------
    if rank == 0:
        graphs.clear()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.time()
        compared, failed = entry.judge(ctx, state, answers, outputs)
        out["reference_s"] = time.time() - t0
        out["compared_answers"] = len(outputs)
        out["compared"] = compared
        out["correct"] = check.passed(compared)
        out["failed"] = failed
    out["forbidden_modules"] = forbidden_modules()
    out["stage"] = "done"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    if spec.get("cores"):
        os.sched_setaffinity(0, spec["cores"])
    if spec.get("fault"):
        # the fault tests' hook: "module:function" breaks the program
        # under the run (benchmark/tests/faults.py); runs never set it
        import importlib
        mod, fn = spec["fault"].split(":")
        getattr(importlib.import_module(mod), fn)(spec["rank"])
    out = {"rank": spec["rank"], "stage": "setup"}
    code = 0
    try:
        run_rank(spec, out)
        if out.get("error"):
            code = 3
    except BaseException as e:             # reported, then re-raised
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()
        code = 1
        if not isinstance(e, Exception):
            _write(spec["out"], out)
            raise
    _write(spec["out"], out)
    return code


if __name__ == "__main__":
    sys.exit(main())
