"""Timeline arithmetic and the reading of a ``torch.profiler`` window.

The interval arithmetic, the naming of idle gaps by the host stage open
over them, and the short kernel names are copies of
``qsvc_tpu_torch/tools/profile.py`` (``merge``, ``clip``, ``covered``,
``idle_gaps``, ``innermost_split``, ``short_name``, ``top_ops``), kept
here so that later changes to the program cannot move the yardstick.
:class:`Profiler` starts and stops a profiler inside a running window and
returns the device's operations on the host's ``time.time()`` clock.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]
#: the label of device idle time that no host stage covers
NO_STAGE = "_no_stage_"
#: the ``record_function`` that puts the host clock on the profiler's
MARKER = "benchmark.clock_marker"


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
    open stage (the latest started, then the first to end) takes it,
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


def stage_intervals(spans: Sequence[dict]) -> List[Tuple[str, float, float]]:
    """Run-log records as (stage, start, end): a record ends at ``ts``
    after lasting ``seconds``."""
    return [(r["stage"], r["ts"] - r["seconds"], r["ts"])
            for r in spans if "seconds" in r]


_NAMESPACES = ("(anonymous namespace)::", "at::native::", "at::", "std::")


def short_name(name: str) -> str:
    """A kernel's name without return type, arguments and common
    namespaces, at most 64 characters; copies and fills keep theirs."""
    if name.startswith("void "):
        name, depth = name[5:], 0
        for ns in _NAMESPACES:
            name = name.replace(ns, "")
        for i, c in enumerate(name):
            depth += c == "<"
            depth -= c == ">"
            if c == "(" and depth == 0:
                name = name[:i]
                break
    return name[:64]


def busy_seconds(ops: Sequence[Tuple[str, float, float]], start: float,
                 end: float) -> float:
    """Seconds of ``[start, end]`` in which some device operation ran."""
    return covered(clip([(a, b) for _, a, b in ops], start, end))


def top_ops(ops: Sequence[Tuple[str, float, float]], start: float,
            end: float, n: int = 10) -> List[list]:
    """The ``n`` device operations of most time inside the window, as
    [short name, seconds]."""
    total: Dict[str, float] = {}
    for name, a, b in ops:
        lo, hi = max(a, start), min(b, end)
        if hi > lo:
            key = short_name(name)
            total[key] = total.get(key, 0.0) + (hi - lo)
    rows = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v] for k, v in rows]


def labelled_gaps(ops: Sequence[Tuple[str, float, float]],
                  spans: Sequence[dict], start: float, end: float,
                  n: int = 10) -> List[list]:
    """The ``n`` longest idle gaps of the device inside the window, each
    as [the host stage that holds most of it, seconds]."""
    stages = [s for s in stage_intervals(spans) if s[2] > start
              and s[1] < end]
    rows = []
    for gap in idle_gaps([(a, b) for _, a, b in ops], start, end)[:n]:
        split = innermost_split(gap, stages)
        rows.append([max(split.items(), key=lambda kv: kv[1])[0],
                     gap[1] - gap[0]])
    return rows


class Profiler:
    """``torch.profiler`` over CPU and CUDA, started and stopped inside a
    running window (:meth:`start`, :meth:`stop`); :meth:`device_ops` then
    gives every kernel, copy and fill it saw on the card as (name, start,
    end) on the host's ``time.time()`` clock, and :attr:`start_t` /
    :attr:`end_t` the traced window on the same clock."""

    def __init__(self):
        self._prof = None
        self.start_t = self.end_t = None
        self._mark_t = None

    def start(self) -> None:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        with record_function(MARKER):
            self._mark_t = time.time()
        self.start_t = self._mark_t

    def stop(self) -> None:
        self.end_t = time.time()
        self._prof.stop()

    def device_ops(self) -> List[Tuple[str, float, float]]:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        rows = [(e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9,
                 e.device_type(), e.is_user_annotation())
                for e in self._prof.profiler.kineto_results.events()]
        mark = next(a for name, a, _b, dt, _u in rows
                    if name == MARKER and dt != cuda)
        offset = self._mark_t - mark
        return [(name, a + offset, b + offset)
                for name, a, b, dt, user in rows
                if dt == cuda and not user and name != MARKER]
