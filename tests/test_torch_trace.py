"""The port's run log (``qsvc_tpu_torch/utils/trace.py``): host spans,
device spans on the host clock and the collector's pauses, nothing at
all without a log, and the spans the streamed encode opens once per
GOP."""

import gc
import json
import time

import pytest
import torch

from qsvc_tpu_torch import api
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.io import synthetic_video
from qsvc_tpu_torch.utils import trace

#: the flagship's shape of configuration at 64x64: 2 GOPs of 2 frames
TINY = dict(pixels_in_x=64, pixels_in_y=64, TRLs=2, GOPs=2, SRLs=2,
            block_size=16, search_range=4, update_factor=0.25,
            quantization_texture=45000)


@pytest.fixture
def log():
    log = trace.RunLog()
    trace.set_run_log(log)
    try:
        yield log
    finally:
        trace.set_run_log(None)


def _named(log, kind):
    return [r for r in log.records if kind in r]


def test_no_log_records_nothing(monkeypatch):
    """Without an installed log: no record, no CUDA event, no hook in
    ``gc.callbacks``."""
    trace.set_run_log(None)
    before = list(gc.callbacks)
    idle = trace.RunLog()

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was made with no run log")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    with trace.stage("host", frames=3):
        pass
    with trace.device_stage("card", "cuda:0"):
        pass
    with trace.device_stage("cpu", "cpu"):
        pass
    gc.collect()
    assert gc.callbacks == before
    assert trace._on_gc not in gc.callbacks
    assert idle.records == []


def test_nested_host_spans(log):
    with trace.stage("outer", frames=3):
        with trace.stage("inner"):
            time.sleep(0.01)
    spans = {r["stage"]: r for r in _named(log, "stage")
             if r["stage"] in ("outer", "inner")}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["frames"] == 3 and inner["seconds"] >= 0.01
    assert set(inner) == {"stage", "seconds", "ts"}
    # the inner span lies inside the outer one on the host clock (to the
    # clock's rounding)
    assert outer["ts"] - outer["seconds"] <= \
        inner["ts"] - inner["seconds"] + 1e-6
    assert inner["ts"] <= outer["ts"]
    assert log.summary()["outer"] == outer["seconds"]


def test_cpu_device_span_has_no_seconds(tmp_path):
    """A device span on the CPU: two host clock readings, no ``stage`` or
    ``seconds`` key (the benchmark's gap labelling reads those as host
    work), mirrored to the log's file like every record."""
    path = tmp_path / "trace.jsonl"
    log = trace.RunLog(path=str(path))
    trace.set_run_log(log)
    try:
        t0 = time.time()
        with trace.device_stage("work", "cpu", sent=4):
            time.sleep(0.005)
    finally:
        trace.set_run_log(None)
    (rec,) = _named(log, "device_stage")
    assert "stage" not in rec and "seconds" not in rec
    assert rec["device_stage"] == "work" and rec["sent"] == 4
    assert rec["device_seconds"] >= 0.005
    assert t0 <= rec["start"] and rec["ts"] == pytest.approx(
        rec["start"] + rec["device_seconds"])
    assert "work" not in log.summary()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert rec in lines


class _Card:
    """A stand-in for a card's timer: an event takes the card's time
    ``now`` when it is recorded and has run once ``done``."""

    def __init__(self):
        self.now = 0.0
        self.syncs = 0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.t, self.done = None, False

            def record(self, stream=None):
                self.t = card.now

            def query(self):
                return self.done

            def synchronize(self):
                self.done = True

            def elapsed_time(self, other):
                return (other.t - self.t) * 1e3

        self.Event = Event

    def synchronize(self, device=None):
        self.syncs += 1


def test_cuda_device_spans_on_the_host_clock(monkeypatch, log):
    """Each CUDA span is placed at the anchor's host time plus the card's
    time since the anchor; one synchronise per device (the anchor's);
    a span is resolved as soon as its events have run, and reading
    ``records`` waits for the rest."""
    card = _Card()
    monkeypatch.setattr(torch.cuda, "Event", card.Event)
    monkeypatch.setattr(torch.cuda, "synchronize", card.synchronize)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: None)
    dev = torch.device("cuda", 0)
    card.now = 10.0
    with trace.device_stage("a", dev, k=1):
        card.now = 10.25
    first = log._pending[0]
    card.now = 11.0
    first[2].done = first[3].done = True
    with trace.device_stage("b", dev):
        card.now = 11.5
    # "a" has run and is resolved; "b" is still queued
    assert [r["device_stage"] for r in log._records
            if "device_stage" in r] == ["a"]
    assert len(log._pending) == 1
    a, b = _named(log, "device_stage")
    assert not log._pending and card.syncs == 1
    t = log._anchors[dev][1]
    assert a == {"device_stage": "a", "k": 1, "device_seconds": 0.25,
                 "start": t, "ts": t + 0.25}
    assert b["start"] == pytest.approx(t + 1.0)
    assert b["device_seconds"] == pytest.approx(0.5)
    assert b["ts"] == pytest.approx(t + 1.5)


def _stand_in_card(monkeypatch, reserved):
    """A stand-in card 0 in use by the process, holding ``reserved``
    bytes."""
    card = _Card()
    monkeypatch.setattr(torch.cuda, "Event", card.Event)
    monkeypatch.setattr(torch.cuda, "synchronize", card.synchronize)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: reserved)
    return card


@pytest.mark.parametrize("reserved", [0, 1 << 20])
def test_installing_a_log_anchors_the_current_card(monkeypatch, reserved):
    """A log installed while the program holds memory on the current card
    takes that card's anchor then, so that its spans take none (no
    synchronise after the install); with nothing on the card the anchor
    waits for the first span."""
    card = _stand_in_card(monkeypatch, reserved)
    dev = torch.device("cuda", 0)
    log = trace.RunLog()
    trace.set_run_log(log)
    try:
        assert (dev in log._anchors) == bool(reserved)
        assert card.syncs == (1 if reserved else 0)
        for k in range(3):
            with trace.device_stage("span", dev, k=k):
                card.now += 0.5
        assert card.syncs == 1
    finally:
        trace.set_run_log(None)
    assert [r["k"] for r in _named(log, "device_stage")] == [0, 1, 2]


def test_clear_keeps_the_anchor(monkeypatch):
    """``clear`` drops the records so far, the pending device spans with
    them, and keeps the anchor: spans after it take no synchronise and
    sit on the same clock."""
    card = _stand_in_card(monkeypatch, 1 << 20)
    dev = torch.device("cuda", 0)
    log = trace.RunLog()
    trace.set_run_log(log)
    try:
        with trace.stage("warm-up"):
            with trace.device_stage("span", dev, k=0):
                card.now = 2.0
        anchor = log._anchors[dev]
        log.clear()
        assert log._pending == []
        assert not _named(log, "device_stage")
        with trace.device_stage("span", dev, k=1):
            card.now = 3.0
    finally:
        trace.set_run_log(None)
    (rec,) = _named(log, "device_stage")
    assert "warm-up" not in [r["stage"] for r in _named(log, "stage")]
    assert rec["k"] == 1 and log._anchors[dev] is anchor
    assert rec["start"] == pytest.approx(anchor[1] + 2.0)
    assert rec["device_seconds"] == pytest.approx(1.0)
    assert card.syncs == 1


def test_a_log_keeps_only_its_names(monkeypatch):
    """A log made with ``only`` records just those spans; the others make
    no record and no CUDA event, and the collector's hook stays out of
    ``gc.callbacks`` unless ``gc.collect`` is kept."""
    before = list(gc.callbacks)

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was made for a span not kept")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    log = trace.RunLog(only=("halo.exchange",))
    trace.set_run_log(log)
    try:
        assert gc.callbacks == before
        with trace.stage("host"):
            with trace.device_stage("graph.f", "cuda:0"):
                pass
            with trace.device_stage("halo.exchange", "cpu", sent=8):
                pass
        gc.collect()
    finally:
        trace.set_run_log(None)
    (rec,) = log.records
    assert rec["device_stage"] == "halo.exchange" and rec["sent"] == 8
    kept = trace.RunLog(only=("gc.collect",))
    trace.set_run_log(kept)
    try:
        assert gc.callbacks.count(trace._on_gc) == 1
    finally:
        trace.set_run_log(None)
    assert gc.callbacks == before


def test_gc_pause_is_a_host_span():
    before = list(gc.callbacks)
    log = trace.RunLog()
    trace.set_run_log(log)
    try:
        trace.set_run_log(log)          # installed twice: one hook
        assert gc.callbacks.count(trace._on_gc) == 1
        gc.collect()
    finally:
        trace.set_run_log(None)
    assert gc.callbacks == before
    spans = [r for r in _named(log, "stage") if r["stage"] == "gc.collect"]
    assert spans and spans[-1]["generation"] == 2
    assert spans[-1]["seconds"] >= 0 and spans[-1]["collected"] >= 0
    n = len(log.records)
    gc.collect()
    assert len(log.records) == n


def test_encode_spans_once_per_gop():
    """``compress_chunks`` on the CPU, the caller serializing each stream:
    the spans of the dispatch's upload, the host selection, the motion
    coding, the assembly and the serialization once per GOP, the captured
    programs as device spans, and the same bytes as with no log."""
    cfg = CodecConfig(**TINY)
    video = synthetic_video(cfg.pictures, 64, 64, seed=3, kind="translate")
    S, gop_cfg = cfg.gop_size, cfg.replace(GOPs=1)
    chunks = [video[g * S:(g + 1) * S + 1] for g in range(cfg.GOPs)]
    plain = [vs.to_bytes() for vs in api.compress_chunks(
        chunks, gop_cfg, reversible=False, device="cpu")]
    log = trace.RunLog()
    got = []
    trace.set_run_log(log)
    try:
        api.compress_chunks(chunks, gop_cfg, reversible=False,
                            progress=lambda i, vs: got.append(vs.to_bytes()),
                            device="cpu")
    finally:
        trace.set_run_log(None)
    assert got == plain
    hosts = [r["stage"] for r in _named(log, "stage")]
    for name in ("upload", "texture_select", "motion_coding",
                 "assemble_stream", "stream.serialize"):
        assert hosts.count(name) == cfg.GOPs, name
    # the texture program's argument copies, once per stack
    assert hosts.count("texture_args_upload") == 2 * cfg.GOPs
    devices = [r["device_stage"] for r in _named(log, "device_stage")]
    assert devices.count("graph._encode_device") == 2 * cfg.GOPs
    assert devices.count("graph.analyze") == cfg.GOPs
    # each upload lies inside its dispatch span (to the clock's rounding)
    spans = _named(log, "stage")
    outer = [(r["ts"] - r["seconds"] - 1e-6, r["ts"] + 1e-6)
             for r in spans if r["stage"] == "upload+mctf_dispatch"]
    for r in spans:
        if r["stage"] == "upload":
            assert any(a <= r["ts"] - r["seconds"] and r["ts"] <= b
                       for a, b in outer)
