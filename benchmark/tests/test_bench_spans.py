"""The readers of the program's own spans (host spans, device spans and
collector pauses of ``utils.trace``) and the unattributed idle share, on
hand-built runs."""

import pytest

from benchmark import spec as specs, timeline
from benchmark.records import Answer, Run, Trace

#: reader -> (record key naming the span, its time field, its span names)
SPAN_READERS = {
    "texture_device_ms": ("device_stage", "device_seconds",
                          ("graph._encode_device",)),
    "mctf_device_ms": ("device_stage", "device_seconds", ("graph.analyze",)),
    "upload_wait_ms": ("stage", "seconds", ("upload",)),
    "assemble_ms": ("stage", "seconds", ("motion_coding", "assemble_stream")),
    "serialize_ms": ("stage", "seconds", ("stream.serialize",)),
    "gc_pause_ms": ("stage", "seconds", ("gc.collect",)),
    "gc_pause_ms.sharded": ("stage", "seconds", ("gc.collect",)),
}


def read(name, run):
    return specs.reader(name)(run)


def window_run(done_times):
    """A 10 s window from 100 s with answers finished at ``done_times``."""
    run = Run("c", {"codec": {}}, {}, 10.0, window_start=100.0)
    run.answers = [Answer(0, t - 0.5, t, 17, 64, 10, advance=16)
                   for t in done_times]
    return run


def span(kind, field, name, ts, seconds):
    if kind == "stage":
        return {"stage": name, "seconds": seconds, "ts": ts}
    return {"device_stage": name, "device_seconds": seconds,
            "start": ts - seconds, "ts": ts}


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_reader_none_without_spans(name):
    run = window_run([101.0, 102.0])
    assert read(name, run) is None
    # spans of other names, or of the other kind, are not read
    kind, field, names = SPAN_READERS[name]
    other = "device_stage" if kind == "stage" else "stage"
    run.spans = [span(kind, field, "other", 101.0, 0.1),
                 span(other, field, names[0], 101.0, 0.1)]
    assert read(name, run) is None


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_reader_per_answer_inside_the_window(name):
    kind, field, names = SPAN_READERS[name]
    # 4 answers finish inside the window (100-110), one after it
    run = window_run([101.0, 103.0, 105.0, 107.0, 111.0])
    run.spans = [span(kind, field, n, ts, 0.02)
                 for ts in (101.0, 102.0, 104.0, 106.0) for n in names]
    # ending before the window or after it: not read
    run.spans += [span(kind, field, names[0], 99.9, 5.0),
                  span(kind, field, names[0], 110.1, 5.0)]
    want = 4 * len(names) * 0.02 / 4 * 1e3
    assert read(name, run) == pytest.approx(want)
    # no answer finished inside the window: nothing to divide by
    run.answers = run.answers[-1:]
    assert read(name, run) is None


def test_assemble_sums_its_two_spans():
    run = window_run([101.0, 102.0])
    run.spans = [span("stage", "seconds", "motion_coding", 101.0, 0.004),
                 span("stage", "seconds", "assemble_stream", 101.0, 0.006),
                 span("stage", "seconds", "motion_coding", 102.0, 0.002),
                 span("stage", "seconds", "assemble_stream", 102.0, 0.008)]
    assert read("assemble_ms", run) == pytest.approx(10.0)


def test_idle_unattributed_share_on_a_synthetic_timeline():
    """Busy 0-2, 3-4 and 6-7 of a 0-10 window: 6 s idle.  Host spans
    cover 2-2.5 (an outer span) with 2.2-2.4 nested inside, 4-5.5 and
    9-11 (past the window's end), so 0.5 + 1.5 + 1 s of the idle time is
    labelled and 3 s (2.5-3, 5.5-6, 7-9) is not: 50 %."""
    ops = [("k", 0.0, 2.0), ("k", 1.0, 1.5), ("k", 3.0, 4.0),
           ("k", 6.0, 7.0)]
    run = window_run([])
    run.trace = Trace(0.0, 10.0, ops, 3)
    run.spans = [{"stage": "outer", "ts": 2.5, "seconds": 0.5},
                 {"stage": "inner", "ts": 2.4, "seconds": 0.2},
                 {"stage": "native_entropy_coding", "ts": 5.5,
                  "seconds": 1.5},
                 {"stage": "gc.collect", "ts": 11.0, "seconds": 2.0},
                 # device spans are no host work
                 {"device_stage": "graph.analyze", "device_seconds": 3.0,
                  "start": 6.0, "ts": 9.0}]
    assert read("idle_unattributed_share", run) == pytest.approx(50.0)
    # the same as the gaps' _no_stage_ label, gap by gap
    stages = timeline.stage_intervals(run.spans)
    gaps = timeline.idle_gaps([(a, b) for _, a, b in ops], 0.0, 10.0)
    none = sum(timeline.innermost_split(g, stages).get(timeline.NO_STAGE, 0)
               for g in gaps)
    assert none == pytest.approx(3.0)
    # no host span at all: every idle second is unattributed
    run.spans = []
    assert read("idle_unattributed_share", run) == pytest.approx(100.0)


def test_idle_unattributed_share_none_without_a_trace():
    run = window_run([101.0])
    assert read("idle_unattributed_share", run) is None
    run.trace = Trace(0.0, 10.0, [], 0)
    assert read("idle_unattributed_share", run) is None
    # a card busy the whole window has no idle time to attribute
    run.trace = Trace(0.0, 10.0, [("k", -1.0, 11.0)], 1)
    assert read("idle_unattributed_share", run) is None
