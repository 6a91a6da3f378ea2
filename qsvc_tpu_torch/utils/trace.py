"""Structured tracing: one run log of host spans, device spans and the
collector's pauses, all on the host's ``time.time()`` clock.

The reference traces in three ways (SURVEY §5): ``mctf.sh`` appends every
dispatched command line to a ``./trace`` file, the ``trace`` wrapper logs
every external codec invocation, and ``-D DEBUG`` prints per-stage
progress.  The one-process equivalent here is a :class:`RunLog` that
collects three kinds of record while it is installed
(:func:`set_run_log`; the CLI's ``--trace PATH`` installs one that
mirrors every record to a JSON-lines file, the ``./trace`` analogue):

* **host spans**, ``stage("name", **meta)``: the host's wall clock over a
  block, ``{"stage", "seconds", "ts", ...}`` with ``ts`` its end.  Device
  work the block only queues is not in it;
* **device spans**, ``device_stage("name", device, **meta)``: two timing
  CUDA events on the device's current stream around the work the block
  queues (on a CPU device, two host clock readings), ``{"device_stage",
  "device_seconds", "start", "ts", ...}``.  A device span has no
  ``stage`` or ``seconds`` key: it says when the card ran the work, not
  what held the host.  Its events are read back without waiting on the
  hot path: reading :attr:`RunLog.records` resolves whatever is pending
  (waiting for it).  ``start`` and ``ts`` are placed on the host clock
  through one anchor per device and log (a synchronise, then an event
  recorded between two ``time.time()`` readings; taken for the current
  device when the log is installed, else at the device's first span),
  so that device spans, host spans and a profiler's device
  operations put on the same clock share one timeline;
* **program spans**, ``program_span("name", device, **meta)``: a device
  span around a region of a captured program (``utils/graphs.py``), the
  same record as a device span's.  While the program is captured, a
  one-thread kernel (the ``stamp`` the capture hands :class:`GraphStamps`,
  ``ops/cuda_lib.stamp`` in ``utils/graphs.py``) writes the card's clock
  into the graph's own stamp tensor at each edge of the region, whether
  or not a log is installed, so the stamps are nodes of the graph and run
  at every replay.  A replay under a log that keeps the region's name and the
  graph's device span stamps its own start, copies the graph's stamps
  after its outputs into a tensor of its own and on to pinned host memory
  without waiting; the log resolves them with the enclosing
  ``graph.<fn name>`` span and places each region inside it, at the span's
  start plus the card's time from the replay's start stamp.  Outside a
  capture (eager on the card, or on the CPU) a program span is a device
  span.  ``fields(**meta)`` adds fields to the program spans opened
  inside it (the MCTF's temporal ``level``);
* **collector pauses**: each run of Python's garbage collector while a
  log is installed, as the host span ``gc.collect`` with its
  ``generation`` and ``collected`` (a ``gc.callbacks`` hook, installed
  with the log and removed with it).

With no log installed nothing is recorded: no record, no CUDA event, no
hook in ``gc.callbacks``.  A log made with ``only`` keeps just the spans
of those names and treats the others, the collector's among them, the
same way (the sharded encode's scaling measurement keeps only its halo
exchanges).
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import json
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)


class RunLog:
    """Collects span records; optionally mirrors them to a JSONL file."""

    def __init__(self, path: Optional[str] = None,
                 only: Optional[Iterable[str]] = None):
        self.path = path
        #: the span names this log keeps (None: every one); under it the
        #: others cost what they cost with no log
        self.only = None if only is None else frozenset(only)
        self._records: List[Dict[str, Any]] = []
        #: device spans whose events are not read yet: (record, device,
        #: begin event, end event, :class:`ReplayStamps` or None)
        self._pending: List[tuple] = []
        #: device -> (anchor event, host time of the anchor)
        self._anchors: Dict[Any, tuple] = {}
        # re-entrant: the collector's hook can run while this thread
        # holds the lock (an allocation inside ``_append`` collects)
        self._lock = threading.RLock()

    def keeps(self, name: str) -> bool:
        return self.only is None or name in self.only

    @property
    def records(self) -> List[Dict[str, Any]]:
        """Every record so far, device spans resolved (waiting for the
        device where a span's work is still queued)."""
        self._resolve(wait=True)
        return self._records

    def _append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._records.append(record)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(record) + "\n")

    def clear(self) -> None:
        """Drop the records so far (waiting for the pending device spans);
        the device anchors stay, so a caller that installs the log before
        a warm-up and clears it after takes no anchor in its timed part."""
        with self._lock:
            self._resolve(wait=True)
            self._records.clear()

    def summary(self) -> Dict[str, float]:
        """Seconds per host span name, summed."""
        out: Dict[str, float] = {}
        for r in self.records:
            if "seconds" in r:
                out[r["stage"]] = out.get(r["stage"], 0.0) + r["seconds"]
        return out

    # -- device spans ------------------------------------------------------

    def _anchor(self, device) -> None:
        """The device's anchor (once per device): with its queue drained,
        an event recorded between two host clock readings, the card's
        moment taken as their midpoint; the tightest of three.  Each
        event is recorded once before its reading, since the first record
        also makes the event, which would widen the bracket."""
        import torch
        with self._lock:
            if device in self._anchors:
                return
            torch.cuda.synchronize(device)
            stream = torch.cuda.current_stream(device)
            best = None
            for _ in range(3):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(stream)
                ev.synchronize()
                t0 = time.time()
                ev.record(stream)
                ev.synchronize()
                t1 = time.time()
                if best is None or t1 - t0 < best[2] - best[1]:
                    best = (ev, t0, t1)
            ev, t0, t1 = best
            self._anchors[device] = (ev, (t0 + t1) / 2)

    def _anchor_current(self) -> None:
        """The current CUDA device's anchor, now, where the program already
        works on that device (holds memory there)."""
        import torch
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return
        index = torch.cuda.current_device()
        if torch.cuda.memory_reserved(index):
            self._anchor(torch.device("cuda", index))

    def _add_device(self, record: Dict[str, Any], device, begin, end,
                    stamps: Optional["ReplayStamps"] = None) -> None:
        with self._lock:
            self._pending.append((record, device, begin, end, stamps))
        self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        """Place the pending device spans on the host clock, oldest first,
        each followed by the program spans of its replay; without ``wait``
        only those whose work and stamps have finished (no
        synchronisation)."""
        with self._lock:
            while self._pending:
                record, device, begin, end, stamps = self._pending[0]
                if not wait and not (end.query() and (
                        stamps is None or stamps.done.query())):
                    return
                end.synchronize()
                anchor, t = self._anchors[device]
                start = t + anchor.elapsed_time(begin) / 1e3
                seconds = begin.elapsed_time(end) / 1e3
                self._pending.pop(0)
                self._append(dict(record, device_seconds=seconds,
                                  start=start, ts=start + seconds))
                if stamps is not None:
                    stamps.done.synchronize()
                    for child in place_stamps(stamps.host.tolist(),
                                              stamps.sites, start):
                        if self.keeps(child["device_stage"]):
                            self._append(child)


_active: Optional[RunLog] = None
#: the host time the running collection started at
_gc_start = [0.0]


def _on_gc(phase: str, info: Dict[str, int]) -> None:
    """``gc.callbacks`` hook: each collection as a ``gc.collect`` span."""
    log = _active
    if log is None:
        return
    if phase == "start":
        _gc_start[0] = time.time()
    else:
        t1 = time.time()
        log._append({"stage": "gc.collect", "seconds": t1 - _gc_start[0],
                     "ts": t1, "generation": info["generation"],
                     "collected": info["collected"]})


def set_run_log(log: Optional[RunLog]) -> Optional[RunLog]:
    """Install (or clear, with None) the process-wide run log and the
    collector's hook; returns the previous log.  Installing a log takes
    the current CUDA device's anchor at once (where the program works on
    it), so that a caller who installs the log before its timed part
    pays the anchor's synchronise outside it."""
    global _active
    prev = _active
    if log is not None:
        log._anchor_current()
    _active = log
    hook = log is not None and log.keeps("gc.collect")
    if hook and _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    elif not hook and _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    return prev


@contextlib.contextmanager
def stage(name: str, **meta):
    """Time a block on the host into the active run log (no-op without
    one, or one that does not keep ``name``)."""
    log = _active
    if log is None or not log.keeps(name):
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        # one reading for the end and the length: an allocation here may
        # collect, which must not move the span's start
        t1 = time.time()
        log._append({"stage": name, "seconds": t1 - t0, "ts": t1, **meta})


@contextlib.contextmanager
def device_stage(name: str, device=None, *,
                 stamps: Optional["ReplayStamps"] = None, **meta):
    """Time on ``device`` (default: the current CUDA device if there is
    one, else the CPU) the work a block queues, into the active run log
    (no-op without one, or one that does not keep ``name``).  ``stamps``:
    the block is a graph's replay, and these are its program spans'
    stamps (:func:`replay_stamps`)."""
    log = _active
    if log is None or not log.keeps(name):
        yield
        return
    import torch
    if device is None:
        device = ("cuda" if torch.cuda.is_available()
                  and torch.cuda.is_initialized() else "cpu")
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.time()
        try:
            yield
        finally:
            t1 = time.time()
            log._append({"device_stage": name, "device_seconds": t1 - t0,
                         "start": t0, "ts": t1, **meta})
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    log._anchor(device)
    # both events made first: nothing is allocated between the block's
    # last queued work and the end event
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(device)
    begin.record(stream)
    try:
        yield
    finally:
        end.record(stream)
        if stamps is not None:
            stamps.fetch()
        log._add_device({"device_stage": name, **meta}, device, begin, end,
                        stamps)


# -- program spans: regions of a captured program ---------------------------

#: the fields :func:`fields` adds to the program spans opened inside it
_fields: contextvars.ContextVar = contextvars.ContextVar(
    "qsvc_trace_fields", default={})
#: the :class:`GraphStamps` of the graph this thread is capturing, if any
_capturing: contextvars.ContextVar = contextvars.ContextVar(
    "qsvc_trace_capturing", default=None)


@contextlib.contextmanager
def fields(**meta):
    """Add ``meta`` to every program span opened inside the block."""
    token = _fields.set({**_fields.get(), **meta})
    try:
        yield
    finally:
        _fields.reset(token)


class GraphStamps:
    """The program spans of one captured graph: each region's name and
    fields in the order the capture opened them, and the graph's stamp
    tensor (int64 on the card, made inside the capture from the graph's
    pool), which holds the card's clock at each region's begin and end,
    slots 2k and 2k + 1, after every replay.  ``write(buf, index)``
    queues the write of the card's clock into ``buf[index]`` on the
    current stream."""

    #: regions one graph may hold
    MAX_SITES = 256

    def __init__(self, write: Callable[[Any, int], None]):
        self.write = write
        self.sites: List[Tuple[str, Dict[str, Any]]] = []
        self.buffer = None

    def stamp(self, device, slot: int) -> None:
        import torch
        if self.buffer is None:
            self.buffer = torch.empty(2 * self.MAX_SITES, dtype=torch.int64,
                                      device=device)
        self.write(self.buffer, slot)

    def open(self, name: str, meta: Dict[str, Any], device) -> int:
        k = len(self.sites)
        if k == self.MAX_SITES:
            raise RuntimeError(f"a captured program holds at most "
                               f"{self.MAX_SITES} program spans")
        self.sites.append((name, meta))
        self.stamp(device, 2 * k)
        return k


@contextlib.contextmanager
def capturing(stamps: GraphStamps):
    """Send this thread's program spans to ``stamps`` while a graph is
    warmed up or captured (``utils/graphs.py``)."""
    token = _capturing.set(stamps)
    try:
        yield stamps
    finally:
        _capturing.reset(token)


@contextlib.contextmanager
def program_span(name: str, device=None, **meta):
    """A device span around a region of a program that may be captured:
    while this thread captures a graph, the region's stamps go into it
    (whatever log is installed); otherwise :func:`device_stage`."""
    meta = {**_fields.get(), **meta}
    stamps = _capturing.get()
    if stamps is None:
        with device_stage(name, device, **meta):
            yield
        return
    k = stamps.open(name, meta, device)
    yield
    stamps.stamp(device, 2 * k + 1)


class ReplayStamps:
    """One replay's program spans on their way to the host: the card's
    clock at the replay's start (slot 0) and the graph's stamps after
    its outputs (slots 1 ...), in a tensor of the replay's own, then
    copied to pinned host memory behind the ``done`` event."""

    def __init__(self, graph: GraphStamps, device):
        import torch
        self.sites = graph.sites
        self.graph = graph
        n = 1 + 2 * len(self.sites)
        self.card = torch.empty(n, dtype=torch.int64, device=device)
        self.host = torch.empty(n, dtype=torch.int64, pin_memory=True)
        self.done = torch.cuda.Event()

    def begin(self) -> None:
        """Stamp the replay's start (before its copy-in)."""
        self.graph.write(self.card, 0)

    def end(self) -> None:
        """Take the graph's stamps (after the replay)."""
        self.card[1:].copy_(self.graph.buffer[:self.card.numel() - 1])

    def fetch(self) -> None:
        """Copy them to the host without waiting."""
        import torch
        self.host.copy_(self.card, non_blocking=True)
        self.done.record(torch.cuda.current_stream(self.card.device))


def replay_stamps(graph: Optional[GraphStamps], name: str, device
                  ) -> Optional[ReplayStamps]:
    """A replay's :class:`ReplayStamps` where the active log keeps the
    replay's device span ``name`` and some region of ``graph``; else
    None (nothing is made or copied)."""
    log = _active
    if (graph is None or not graph.sites or log is None
            or not log.keeps(name)
            or not any(log.keeps(n) for n, _ in graph.sites)):
        return None
    return ReplayStamps(graph, device)


def place_stamps(values: Sequence[int],
                 sites: Sequence[Tuple[str, Dict[str, Any]]],
                 start: float) -> List[Dict[str, Any]]:
    """The device span records of one replay's regions: ``values`` the
    card's clock in ns at the replay's start, then at each region's begin
    and end in the order of ``sites`` ((name, fields)); ``start`` the
    host time at which the replay's device span starts.  Each region
    starts at ``start`` plus the card's time from the replay's start to
    its begin stamp (so it lies inside the span, which opened before the
    replay's start stamp and closes after the last region)."""
    out = []
    for k, (name, meta) in enumerate(sites):
        b, e = values[1 + 2 * k], values[2 + 2 * k]
        t = start + (b - values[0]) / 1e9
        out.append({"device_stage": name, **meta,
                    "device_seconds": (e - b) / 1e9, "start": t,
                    "ts": t + (e - b) / 1e9})
    return out
