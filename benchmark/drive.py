"""The general generator: what every mix's entry shares.

A mix (``traffic/<mix>.json``) names the program's call it drives
(``entry``, a module ``entries/<entry>.py``) and the video it feeds
(``content``, a module ``content/<content>.py``); the rest of its keys
are parameters that those two read.  Each entry module has:

* ``setup(ctx) -> state``: the frames, the program's prewarm and the
  mix's warm-up answers, counted as set-up;
* ``drive(ctx, state, tracer, on_start) -> (answers, outputs)``: the
  window, closed loop: calls ``on_start(t)`` as the window starts, ticks
  ``tracer`` at each answer's start, returns every answer taken
  (:class:`.records.Answer`, with its frames and bytes) and, on the rank
  that judges, what each produced by answer index;
* ``frame_count(codec, traffic)``: how many frames of the content a
  run is fed from;
* ``pieces(codec, traffic, frames, seed) -> {item: input}``: the input
  of every item a run with ``seed`` can answer (the reference's and the
  control's input);
* ``judge(ctx, state, answers, outputs) -> (compared, failed)``: the
  numbers that decide ``correct``, each beside its limit, and how many
  answers failed.

``trace_from`` and ``trace_length`` place the traced part of a
``--trace 1`` run's window, in whatever unit the entry ticks its tracer
with: seconds into the window, or answers.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, List, Optional

from .records import Trace
from .timeline import Profiler


class TraceWindow:
    """Starts the profiler at the first answer boundary (a call of
    :meth:`tick`) at which the window's progress reaches ``start`` and
    stops it at the first at which it reaches ``start + length``; inert
    when ``enabled`` is false."""

    def __init__(self, enabled: bool, start: float, length: float):
        self.enabled = enabled
        self.start, self.length = start, length
        self.prof: Optional[Profiler] = None
        self.answers = 0
        self.done = False

    def tick(self, progress: float) -> None:
        if not self.enabled or self.done:
            return
        if self.prof is None:
            if progress >= self.start:
                self.prof = Profiler()
                self.prof.start()
        elif progress >= self.start + self.length:
            self.stop()
            return
        if self.prof is not None:
            self.answers += 1

    def stop(self) -> None:
        if self.prof is not None and not self.done:
            self.prof.stop()
            self.done = True

    def result(self) -> Optional[Trace]:
        if self.prof is None:
            return None
        self.stop()
        return Trace(self.prof.start_t, self.prof.end_t,
                     self.prof.device_ops(), self.answers)


def warm_profiler() -> None:
    """Start and stop a profiler once, so that the traced window does
    not pay CUPTI's first start."""
    prof = Profiler()
    prof.start()
    prof.stop()
    prof.device_ops()


def feed_order(seed: int, pool: int) -> List[int]:
    """The order, drawn from ``seed``, in which the pool is fed."""
    return random.Random(seed).sample(range(pool), pool)


@dataclass
class Context:
    """What an entry gets from its rank: the rank's spec (the cell's
    configuration and traffic, the seed, the window's length, the rank's
    place), its device and ``step(name)``, which closes a timed step of
    set-up."""
    spec: dict
    device: object
    step: Callable[[str], None]

    @property
    def codec(self) -> dict:
        return self.spec["config"]["codec"]

    @property
    def traffic(self) -> dict:
        return self.spec["traffic"]

    def frames(self, count: int, height: int, width: int):
        """``count`` frames of the mix's content, as host uint8 planes."""
        from . import spec as specs
        content = specs.module("content", self.traffic["content"])
        return content.make(count, height, width, self.traffic,
                            self.device)
