"""Arithmetic the readers of the program's own spans share: a span's
time summed over the window and divided by the answers (GOP streams, or
sharded calls) finished inside it."""

from __future__ import annotations

from typing import Optional


def _per_answer_ms(run, kind: str, field: str, names) -> Optional[float]:
    done = len(run.finished())
    spans = [r for r in run.spans if r.get(kind) in names
             and run.window_start <= r["ts"] <= run.window_end]
    if not done or not spans:
        return None
    return sum(r[field] for r in spans) / done * 1e3


def host_ms(run, *names: str) -> Optional[float]:
    """The host seconds of the host spans ``names`` that ended inside the
    window, per answer finished inside it, in ms; None without either."""
    return _per_answer_ms(run, "stage", "seconds", names)


def device_ms(run, *names: str) -> Optional[float]:
    """The device seconds of the device spans ``names`` that ended inside
    the window, per answer finished inside it, in ms; None without
    either."""
    return _per_answer_ms(run, "device_stage", "device_seconds", names)
