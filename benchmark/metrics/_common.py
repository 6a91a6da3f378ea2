"""Arithmetic the readers share."""

from __future__ import annotations

from typing import Optional, Sequence


def quantile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile of ``values``, linear between the order
    statistics at (n - 1) q; None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean_span_ms(run, *names: str) -> Optional[float]:
    """The summed seconds of the spans ``names`` that ended inside the
    window, per span of the first name, in ms; None without spans."""
    count = len(run.spans_named(names[0]))
    if count == 0:
        return None
    total = sum(r["seconds"] for n in names for r in run.spans_named(n))
    return total / count * 1e3


def idle_percent(run) -> Optional[float]:
    """100 (1 - busy / window) over the traced part of the window."""
    from benchmark.timeline import busy_seconds
    tr = run.trace
    if tr is None or tr.end <= tr.start or not tr.ops:
        return None
    busy = busy_seconds(tr.ops, tr.start, tr.end)
    return 100.0 * (1.0 - busy / (tr.end - tr.start))


def completed(run) -> float:
    """How many answers the window completed: those finished inside it,
    and the share of the one finishing across its end that fell inside
    (the completion count read between its two neighbouring completions),
    so that a call cut by the window's end counts for the part of it that
    the window held."""
    done = sorted(a.t_done for a in run.answers if a.t_done is not None)
    end = run.window_end
    inside = [t for t in done if t <= end]
    after = [t for t in done if t > end]
    if not after:
        return float(len(inside))
    prev = inside[-1] if inside else run.window_start
    return len(inside) + (end - prev) / (after[0] - prev)


def frames_per_second(run) -> Optional[float]:
    """The frames the completed answers move the feed forward, over the
    window's seconds; None where no answer advances the feed."""
    advance = max((a.advance for a in run.answers), default=0)
    if not advance:
        return None
    return advance * completed(run) / run.seconds
