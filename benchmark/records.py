"""What a run leaves for the metric readers, all on the host's
``time.time()`` clock: the window, every answer (a GOP's stream, or a
sharded call's), the program's spans (``utils.trace`` records) and, in a
traced run, the device operations of the traced part of the window."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Answer:
    """One unit of work the traffic asked for: taken from the feed at
    ``t_taken``, its stream finished at ``t_done`` (None: never)."""
    item: int                 # which item of the mix it encodes
    t_taken: float
    t_done: Optional[float] = None
    frames: int = 0           # frames its stream codes
    pixels: int = 0           # luma pixels of a frame
    nbytes: Optional[int] = None
    advance: int = 0          # frames it moves the feed forward


@dataclass
class Trace:
    """The traced part of the window: ``ops`` are the device's kernels,
    copies and fills as (name, start, end); ``answers`` how many answers
    began inside it."""
    start: float
    end: float
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    answers: int = 0


@dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    seconds: float
    window_start: float = 0.0
    setup_s: float = 0.0
    answers: List[Answer] = field(default_factory=list)
    spans: List[dict] = field(default_factory=list)
    trace: Optional[Trace] = None

    @property
    def window_end(self) -> float:
        return self.window_start + self.seconds

    def finished(self) -> List[Answer]:
        """The answers whose stream was finished inside the window."""
        return [a for a in self.answers
                if a.t_done is not None and a.t_done <= self.window_end]

    def spans_named(self, name: str) -> List[dict]:
        """The spans ``name`` that ended inside the window."""
        return [r for r in self.spans if r.get("stage") == name
                and self.window_start <= r["ts"] <= self.window_end]
