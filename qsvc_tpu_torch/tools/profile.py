"""Device-time attribution on the card, shared by the ``profile_*`` tools.

:func:`device_profile` runs a function once under ``torch.profiler``
(CPU and CUDA activities) and reads one window from the trace:

- its wall time (host clock, ended by a synchronise);
- the device's busy seconds and share: the union of the kernel, copy and
  fill intervals the profiler saw on the card inside the window;
- the top device operations by total time, with their counts, and the
  launches of the port's kernels as the profiler counted them beside
  ``ops.cuda_lib.launches`` over the same window;
- the longest idle gaps of the device, each labelled with the
  ``utils.trace`` stage that was open on the host at the time (the
  innermost one; a gap that spans several is split among them, and the
  label is the one that holds most of it).  A run-log record ends at
  ``ts`` and lasts ``seconds``; one marker (a ``record_function`` entered
  at a known ``time.time()``) maps the host clock onto the profiler's;
- the share of the window that no stage covers;
- ``nvidia-smi`` samples of the card's SM clock, power draw and
  temperature taken inside the window by one ``nvidia-smi -lms``
  process, and the card's name and power limit.

The window's wall and busy share carry the profiler's own overhead: set
them beside the unprofiled walls of the same work.  Kernels replayed
from a CUDA graph show up as kernels only if CUPTI resolves graph nodes;
:func:`device_profile` fails where the profiler's count of a kernel of
``csrc/`` differs from the launches the wrappers counted.  On the CPU
nothing here runs: there is no device time to read.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import threading
import time
from datetime import datetime
from typing import Dict, List, Sequence, Tuple

import torch

from ..ops import cuda_lib
from ..utils import trace
from .bench import card_uuid, device_name, launches_since

#: the kernels of ``csrc/`` by their launch-counter name, and the part of
#: the kernel's demangled name the profiler shows
KERNELS = {"me_refine": "me_refine_kernel",
           "mc_predict": "mc_predict_kernel",
           "mc_update2": "mc_update_kernel<2>",
           "mc_update1": "mc_update_kernel<1>",
           "bp_slope": "bp_slope_kernel"}
#: what ``nvidia-smi`` is asked beside a window
SMI_QUERY = "name,power.limit,clocks.sm,power.draw,temperature.gpu"
#: the ``record_function`` that marks a window on the profiler's clock
MARKER = "qsvc.profile.window"
#: the label of device idle time that no stage covers
NO_STAGE = "(no stage)"

Interval = Tuple[float, float]


# -- timeline arithmetic (seconds on one clock) ---------------------------

def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals: Sequence[Interval], start: float, end: float
         ) -> List[Interval]:
    """``intervals`` cut to ``[start, end]``; empty ones dropped."""
    return [(max(a, start), min(b, end)) for a, b in intervals
            if min(b, end) > max(a, start)]


def covered(intervals: Sequence[Interval]) -> float:
    """Seconds covered by the union of ``intervals``."""
    return sum(b - a for a, b in merge(intervals))


def idle_gaps(busy: Sequence[Interval], start: float, end: float
              ) -> List[Interval]:
    """The parts of ``[start, end]`` that no interval of ``busy`` covers,
    longest first."""
    gaps, t = [], start
    for a, b in merge(clip(busy, start, end)):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if end > t:
        gaps.append((t, end))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def innermost_split(gap: Interval, stages: Sequence[Tuple[str, float, float]]
                    ) -> Dict[str, float]:
    """Seconds of ``gap`` under each stage: at every instant the innermost
    open stage (of the open ones, the latest started, then the first to
    end: nested stages lie inside their parents) takes it,
    :data:`NO_STAGE` where none is open."""
    a, b = gap
    cuts = sorted({a, b} | {t for _, s, e in stages for t in (s, e)
                            if a < t < b})
    out: Dict[str, float] = {}
    for lo, hi in zip(cuts, cuts[1:]):
        mid = (lo + hi) / 2
        open_ = [(s, -e, name) for name, s, e in stages if s <= mid < e]
        label = max(open_)[2] if open_ else NO_STAGE
        out[label] = out.get(label, 0.0) + (hi - lo)
    return out


def label_gaps(gaps: Sequence[Interval],
               stages: Sequence[Tuple[str, float, float]], origin: float,
               n: int) -> List[dict]:
    """The ``n`` longest ``gaps``, each with its start after ``origin``,
    its length, the stage holding most of it and the split by stage."""
    rows = []
    for gap in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        split = innermost_split(gap, stages)
        rows.append({"start": gap[0] - origin, "seconds": gap[1] - gap[0],
                     "stage": max(split.items(), key=lambda kv: kv[1])[0],
                     "stages": split})
    return rows


#: namespaces dropped from kernel names
_NAMESPACES = ("(anonymous namespace)::", "at::native::", "at::", "std::")


def short_name(name: str) -> str:
    """A kernel's name without its return type, argument list and the
    namespaces of :data:`_NAMESPACES` (templates kept), at most 120
    characters; copies and fills keep their names."""
    if not name.startswith("void "):
        return name[:120]
    name, depth = name[5:], 0
    for ns in _NAMESPACES:
        name = name.replace(ns, "")
    for i, c in enumerate(name):
        depth += c == "<"
        depth -= c == ">"
        if c == "(" and depth == 0:
            name = name[:i]
            break
    return name[:120]


def top_ops(ops: Sequence[Tuple[str, float, float]], n: int) -> List[dict]:
    """The ``n`` device operations of most total time: ``ops`` are
    (name, start, end); rows of name, seconds and count."""
    total: Dict[str, List[float]] = {}
    for name, a, b in ops:
        row = total.setdefault(short_name(name), [0.0, 0])
        row[0] += b - a
        row[1] += 1
    rows = sorted(total.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k, "seconds": s, "count": c} for k, (s, c) in rows]


def kernel_counts(ops: Sequence[Tuple[str, float, float]]) -> Dict[str, int]:
    """Launches of the kernels of ``csrc/`` among ``ops``, by counter
    name."""
    return {key: sum(1 for name, _, _ in ops if part in name)
            for key, part in KERNELS.items()}


def stage_intervals(records: Sequence[dict], offset: float
                    ) -> List[Tuple[str, float, float]]:
    """``utils.trace`` records as (stage, start, end), moved onto another
    clock by ``offset`` seconds (a record ends at ``ts`` after lasting
    ``seconds``)."""
    return [(r["stage"], r["ts"] - r["seconds"] + offset, r["ts"] + offset)
            for r in records if "seconds" in r]


def outermost_seconds(stages: Sequence[Tuple[str, float, float]]) -> float:
    """Seconds of the stages that lie inside no other stage: a nested
    span (``upload`` inside ``upload+mctf_dispatch``, a ``gc.collect``
    inside any stage) is already part of its parent's time."""
    total, end = 0.0, float("-inf")
    for _, a, b in sorted(stages, key=lambda s: (s[1], -s[2])):
        if b > end:
            total += b - a
            end = b
    return total


def window_summary(ops: Sequence[Tuple[str, float, float]],
                   records: Sequence[dict], start: float, end: float,
                   offset: float, top: int = 10, n_gaps: int = 5) -> dict:
    """Everything :func:`device_profile` reads from one window
    ``[start, end]`` of the profiler's clock: ``ops`` are the device
    operations (name, start, end), ``records`` the run log's records and
    ``offset`` what moves their clock onto the profiler's."""
    span = end - start
    ops = [(name, a, b) for name, a, b in ops if b > start and a < end]
    busy = covered(clip([(a, b) for _, a, b in ops], start, end))
    stages = [s for s in stage_intervals(records, offset)
              if s[2] > start and s[1] < end]
    staged = covered(clip([(a, b) for _, a, b in stages], start, end))
    summary: Dict[str, float] = {}
    for name, a, b in stages:
        summary[name] = summary.get(name, 0.0) + (b - a)
    return {
        "wall_s": span,
        "busy_s": busy,
        "busy_share": busy / span if span > 0 else 0.0,
        "device_ops": len(ops),
        "top_ops": top_ops(ops, top),
        "kernels": kernel_counts(ops),
        "gaps": label_gaps(idle_gaps([(a, b) for _, a, b in ops], start,
                                     end), stages, start, n_gaps),
        "stages_s": summary,
        "stages_sum_s": sum(summary.values()),
        "stages_outer_s": outermost_seconds(stages),
        "staged_s": staged,
        "unstaged_share": 1.0 - staged / span if span > 0 else 0.0,
    }


# -- the card -------------------------------------------------------------

def parse_smi_line(line: str):
    """One line of ``nvidia-smi --query-gpu=timestamp,<SMI_QUERY>
    --format=csv,noheader,nounits`` as (host time, its five fields), or
    None if it is not one."""
    fields = [f.strip() for f in line.split(",")]
    if len(fields) != 6:
        return None
    try:
        t = datetime.strptime(fields[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
    except ValueError:
        return None
    return t, fields[1:]


class SmiSampler:
    """One ``nvidia-smi --query-gpu=... -lms PERIOD`` process on the card
    ``card`` (a UUID, :func:`bench.card_uuid`: ``nvidia-smi``'s own
    numbering ignores ``CUDA_VISIBLE_DEVICES``) while the ``with`` block
    runs; each sample carries ``nvidia-smi``'s own timestamp.  The block
    starts once the first sample is in."""

    def __init__(self, card: str, period_ms: int = 50):
        self.cmd = ["nvidia-smi", "-i", card,
                    f"--query-gpu=timestamp,{SMI_QUERY}",
                    "--format=csv,noheader,nounits", "-lms", str(period_ms)]
        #: (host time of the sample, its five fields)
        self.samples: List[Tuple[float, List[str]]] = []
        self._first = threading.Event()
        self._proc = None

    def _read(self):
        for line in self._proc.stdout:
            sample = parse_smi_line(line)
            if sample is not None:
                self.samples.append(sample)
                self._first.set()

    def __enter__(self):
        try:
            self._proc = subprocess.Popen(
                self.cmd, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()
        self._first.wait(10)
        return self

    def __exit__(self, *exc):
        if self._proc is None:
            return
        self._proc.terminate()
        try:
            self._proc.wait(10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._thread.join(10)

    def summary(self, start: float, end: float) -> dict:
        """Name, power limit and min / median / max of the SM clock (MHz),
        power draw (W) and temperature (C) over the samples taken inside
        ``[start, end]`` (host clock): the window's."""
        rows = [row for t, row in self.samples if start <= t <= end]
        if not rows:
            return {"samples": 0}
        out = {"samples": len(rows), "name": rows[0][0],
               "power_limit_w": rows[0][1]}
        for key, i in (("clocks_sm_mhz", 2), ("power_draw_w", 3),
                       ("temperature_c", 4)):
            vals = []
            for row in rows:
                try:
                    vals.append(float(row[i]))
                except ValueError:          # "[N/A]"
                    pass
            if vals:
                out[key] = [min(vals), statistics.median(vals), max(vals)]
        return out


@contextlib.contextmanager
def swapped(swaps):
    """Module attributes replaced for the ``with`` block: ``swaps`` are
    (module, name, value); the old values come back on exit."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, value in swaps:
            setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def eager_programs():
    """The API with its captured programs swapped for their eager
    functions, as a context manager, for comparing the two (the port has
    no such switch itself)."""
    from ..codec import frame_codec
    from ..mctf import motion_coding, transform
    return swapped([
        (transform, "analyze_jit", transform.analyze),
        (transform, "synthesize_jit", transform.synthesize),
        (motion_coding, "decorrelate_jit", motion_coding.decorrelate),
        (motion_coding, "correlate_jit", motion_coding.correlate),
        (frame_codec, "_encode_device_jit", frame_codec._encode_device),
        (frame_codec, "_dequant_idwt_jit", frame_codec._dequant_idwt)])


def synced(name: str, fn, device):
    """``fn`` as a ``utils.trace`` stage ``name`` that ends when
    ``device`` has finished the work it queued."""
    def run(*args, **kwargs):
        with trace.stage(name):
            out = fn(*args, **kwargs)
            sync(device)
        return out
    return run


def window(fn, smi: bool = True) -> dict:
    """One run of ``fn`` under the profiler and a run log: its window's
    summary (:func:`window_summary`), the host's wall, the launches the
    wrappers counted, the host's CUDA launch calls and, with ``smi``,
    the ``nvidia-smi`` samples taken inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    log = trace.RunLog()
    prev = trace.set_run_log(log)
    before = dict(cuda_lib.launches)
    sampler = (SmiSampler(card_uuid(torch.cuda.current_device())) if smi
               else contextlib.nullcontext())
    try:
        torch.cuda.synchronize()
        with sampler, profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            with record_function(MARKER):
                fn()
                torch.cuda.synchronize()
            host_wall = time.time() - t0
    finally:
        trace.set_run_log(prev)
    launches = launches_since(before)
    events = prof.events()
    marker = next(e for e in events if e.name == MARKER)
    start, end = marker.time_range.start * 1e-6, marker.time_range.end * 1e-6
    # kernels, copies and fills; not the marker's own range, which the
    # profiler also draws on the device's timeline
    ops = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
           for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name != MARKER]
    out = window_summary(ops, log.records, start, end, start - t0)
    out["host_wall_s"] = host_wall
    out["launches"] = launches
    out["host_launches"] = sum(
        1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
        and e.name.startswith("cu") and "Launch" in e.name)
    out["smi"] = sampler.summary(t0, t0 + host_wall) if smi else None
    return out


def resolved(window: dict) -> bool:
    """Whether the profiler saw every launch of the kernels of ``csrc/``
    that the wrappers counted in ``window`` (graph nodes resolved)."""
    return all(window["kernels"].get(k, 0) == n
               for k, n in window["launches"].items() if k in KERNELS)


def device_profile(fn) -> dict:
    """Profile one call of ``fn`` on the current card (see the module
    docstring): :func:`window` with the card's name and power limit under
    ``device``.  Exits with a message if the profiler did not see every
    launch of a kernel of ``csrc/`` that the wrappers counted."""
    out = window(fn)
    if not resolved(out):
        raise SystemExit(f"device_profile: the profiler saw the kernels "
                         f"{out['kernels']}, the wrappers launched "
                         f"{out['launches']}: CUDA graph nodes not resolved")
    out["device"] = device_name(torch.device("cuda"))
    return out


def print_profile(title: str, prof: dict) -> None:
    """The profile's lines: wall, busy share, top operations, kernel counts
    beside the launch counters, gaps with their stages, the stages'
    coverage and the card's clocks and power."""
    print(f"{title} [{prof['device']}]", flush=True)
    print(f"  window: wall {prof['wall_s']:.6f} s (profiled), device busy "
          f"{prof['busy_s']:.6f} s = {prof['busy_share']:.4f} of the window, "
          f"{prof['device_ops']} device operations, {prof['host_launches']} "
          f"host launches", flush=True)
    for i, op in enumerate(prof["top_ops"], start=1):
        print(f"  top {i}: {op['seconds']:.6f} s x{op['count']} "
              f"{op['name']}", flush=True)
    print(f"  kernels: profiler {prof['kernels']} vs launch counters "
          f"{prof['launches']}", flush=True)
    for g in prof["gaps"]:
        print(f"  gap at +{g['start']:.6f} s: {g['seconds']:.6f} s under "
              f"{g['stage']}", flush=True)
    print(f"  stages: sum {prof['stages_sum_s']:.6f} s, outermost "
          f"{prof['stages_outer_s']:.6f} s, union "
          f"{prof['staged_s']:.6f} s, window not under any stage "
          f"{prof['unstaged_share']:.4f}; "
          + ", ".join(f"{k} {v:.6f}" for k, v in
                      sorted(prof["stages_s"].items(), key=lambda kv: -kv[1])),
          flush=True)
    print(f"  nvidia-smi inside the window: {json.dumps(prof['smi'])}",
          flush=True)


def median_seconds(fn, reps: int, device="cuda") -> tuple:
    """``fn()`` once to warm up, then ``reps`` times, each run between two
    synchronises of ``device``: (the median seconds, the last result)."""
    out = fn()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def sync(device) -> None:
    """Wait for ``device`` (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def needs_card(tool: str) -> bool:
    """Whether a card is visible; if not, say so on stderr."""
    if torch.cuda.is_available():
        return True
    print(f"{tool}: no CUDA device", file=sys.stderr)
    return False


def write_json(path: str, obj) -> None:
    """Write ``obj`` to ``path`` as JSON (nothing without a path)."""
    if path:
        with open(path, "w") as f:
            json.dump(obj, f, indent=1)
