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


# -- program spans: the MCTF's sub-pixel interpolation ----------------------

#: a quarter-pel GOP of 4 (levels 1 and 2) at 64x128
SUBPEL = dict(pixels_in_x=128, pixels_in_y=64, TRLs=3, GOPs=1, SRLs=3,
              block_size=16, search_range=4, subpixel_accuracy=2)


def _frames(cfg):
    video = synthetic_video(cfg.pictures, cfg.pixels_in_y, cfg.pixels_in_x,
                            seed=5, kind="translate", velocity=(1.25, 2.5))
    return [torch.from_numpy(p) for p in (video.y, video.u, video.v)]


def _interp_samples(cfg):
    """(level, part, step) -> the samples its region writes, from the
    shapes: per level the evens and odds to 2x and 4x (the motion
    search's steps), the 4:4:4 evens to 2x then 4x, the 4:4:4
    predictions from 4x to 2x then 1x."""
    H, W = cfg.pixels_in_y, cfg.pixels_in_x
    out = {}
    for lp in cfg.level_schedule():
        t, P = lp.temporal_subband, lp.pictures // 2
        out[(t, "me_up", 1)] = (2 * P + 1) * (2 * H) * (2 * W)
        out[(t, "me_up", 2)] = (2 * P + 1) * (4 * H) * (4 * W)
        out[(t, "pred_up", None)] = 3 * (P + 1) * (
            (2 * H) * (2 * W) + (4 * H) * (4 * W))
        out[(t, "pred_down", None)] = 3 * P * (
            (2 * H) * (2 * W) + H * W)
    return out


@pytest.mark.parametrize("a", [0, 2])
def test_interp_spans_of_a_subpel_analyze(log, a):
    """On the CPU a quarter-pel ``analyze`` under a log gives one
    ``mctf.interp`` device span per region of every level, inside the
    program's own span, each with its ``samples`` and ``bytes`` (int16:
    2 bytes a sample read or written); whole-pixel gives none."""
    from qsvc_tpu_torch.mctf import transform
    cfg = CodecConfig(**dict(SUBPEL, subpixel_accuracy=a))
    transform.analyze_jit(*_frames(cfg), cfg)
    spans = [r for r in _named(log, "device_stage")
             if r["device_stage"] == "mctf.interp"]
    if a == 0:
        assert spans == []
        return
    want = _interp_samples(cfg)
    got = {(r["level"], r["part"], r.get("step")): r["samples"]
           for r in spans}
    assert got == want and len(spans) == len(want)
    (outer,) = [r for r in _named(log, "device_stage")
                if r["device_stage"] == "graph.analyze"]
    for r in spans:
        assert r["device_seconds"] >= 0 and "seconds" not in r
        assert outer["start"] <= r["start"] and r["ts"] <= outer["ts"]
    # the least traffic, int16: each region reads its first input once
    # (me_up's later step reads none: step 1 wrote it) and writes what
    # leaves it (pred_up and pred_down their last step's output only)
    H, W = cfg.pixels_in_y, cfg.pixels_in_x
    for r in spans:
        P = {1: 2, 2: 1}[r["level"]]
        want_bytes = {
            ("me_up", 1): (2 * P + 1) * (1 + 4) * H * W,
            ("me_up", 2): (2 * P + 1) * 16 * H * W,
            ("pred_up", None): 3 * (P + 1) * (1 + 16) * H * W,
            ("pred_down", None): 3 * P * (16 + 1) * H * W,
        }[(r["part"], r.get("step"))]
        assert r["bytes"] == 2 * want_bytes, r


def test_interp_spans_without_a_log_record_nothing(monkeypatch):
    from qsvc_tpu_torch.mctf import transform

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was made with no run log")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    trace.set_run_log(None)
    idle = trace.RunLog()
    cfg = CodecConfig(**SUBPEL)
    transform.analyze_jit(*_frames(cfg), cfg)
    assert idle.records == []


@pytest.mark.parametrize("a", [0, 2])
def test_capture_takes_each_region_as_two_stamps(a):
    """While a program is captured its regions become stamps (whatever
    log is installed): begin and end of region k at slots 2k and 2k + 1
    of the graph's stamp tensor, in the order the card runs them, each
    region's fields kept for the replays; whole-pixel takes none."""
    from qsvc_tpu_torch.mctf import transform
    slots = []
    trace.set_run_log(None)
    cfg = CodecConfig(**dict(SUBPEL, subpixel_accuracy=a))
    stamps = trace.GraphStamps(lambda buf, index: slots.append(index))
    with trace.capturing(stamps):
        transform.analyze(*_frames(cfg), cfg)
    if a == 0:
        assert stamps.sites == [] and slots == [] and stamps.buffer is None
        return
    assert slots == list(range(2 * len(stamps.sites)))
    assert [(m["level"], m["part"], m.get("step"))
            for _, m in stamps.sites] == list(_interp_samples(cfg))
    assert {n for n, _ in stamps.sites} == {"mctf.interp"}
    assert stamps.buffer.dtype == torch.int64


def test_place_stamps_gives_each_region_its_card_time():
    sites = [("mctf.interp", {"level": 1, "part": "pred_up"}),
             ("mctf.interp", {"level": 1, "part": "pred_down"})]
    g0 = 7_000_000_000_000
    values = [g0, g0 + 1_000_000, g0 + 3_500_000, g0 + 3_600_000,
              g0 + 4_100_000]
    a, b = trace.place_stamps(values, sites, 50.0)
    assert a == {"device_stage": "mctf.interp", "level": 1,
                 "part": "pred_up", "device_seconds": 0.0025,
                 "start": 50.001, "ts": pytest.approx(50.0035)}
    assert b["part"] == "pred_down"
    assert b["device_seconds"] == pytest.approx(0.0005)
    assert b["start"] == pytest.approx(50.0036)
    assert b["ts"] == pytest.approx(50.0041)


class _ReplayStamps:
    """A stand-in for a replay's stamps on their way to the host:
    ``values`` as the card wrote them, readable once ``done`` has run."""

    def __init__(self, card, sites, values):
        self.sites = sites
        self.host = torch.tensor(values, dtype=torch.int64)
        self.done = card.Event(enable_timing=True)
        self.fetched = 0

    def fetch(self):
        self.fetched += 1
        self.done.record()


def test_two_replays_in_flight_keep_their_own_regions(monkeypatch, log):
    """Two replays of one stamped program queued before either ran: each
    replay's regions are placed inside its own device span, from its own
    stamps, and none is resolved before its stamps reached the host."""
    card = _Card()
    monkeypatch.setattr(torch.cuda, "Event", card.Event)
    monkeypatch.setattr(torch.cuda, "synchronize", card.synchronize)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: None)
    dev = torch.device("cuda", 0)
    sites = [("mctf.interp", {"level": 1, "part": "me_up", "step": 1}),
             ("mctf.interp", {"level": 1, "part": "pred_up"})]
    ns = 1_000_000
    first = _ReplayStamps(card, sites, [10 * ns, 12 * ns, 20 * ns,
                                        30 * ns, 33 * ns])
    second = _ReplayStamps(card, sites, [90 * ns, 91 * ns, 92 * ns,
                                         95 * ns, 99 * ns])
    card.now = 100.0
    with trace.device_stage("graph.analyze", dev, stamps=first):
        card.now = 100.040
    with trace.device_stage("graph.analyze", dev, stamps=second):
        card.now = 100.060
    assert first.fetched == second.fetched == 1
    # the first replay's work has run, its stamps not yet: nothing placed
    p = log._pending[0]
    p[2].done = p[3].done = True
    log._resolve(wait=False)
    assert not [r for r in log._records if "device_stage" in r]
    first.done.done = True
    log._resolve(wait=False)
    assert [r["device_stage"] for r in log._records
            if "device_stage" in r] == ["graph.analyze", "mctf.interp",
                                        "mctf.interp"]
    spans = _named(log, "device_stage")
    assert [r["device_stage"] for r in spans] == [
        "graph.analyze", "mctf.interp", "mctf.interp"] * 2
    outer1, a1, b1, outer2, a2, b2 = spans
    assert (a1["device_seconds"], b1["device_seconds"]) == pytest.approx(
        (0.008, 0.003))
    assert (a2["device_seconds"], b2["device_seconds"]) == pytest.approx(
        (0.001, 0.004))
    assert a1["start"] == pytest.approx(outer1["start"] + 0.002)
    assert b1["start"] == pytest.approx(outer1["start"] + 0.020)
    assert a2["start"] == pytest.approx(outer2["start"] + 0.001)
    assert b2["start"] == pytest.approx(outer2["start"] + 0.005)
    for outer, regions in ((outer1, (a1, b1)), (outer2, (a2, b2))):
        for r in regions:
            assert outer["start"] <= r["start"] and r["ts"] <= outer["ts"]
    assert a1["step"] == 1 and b2["part"] == "pred_up"


def test_replay_stamps_only_under_a_log_that_keeps_them():
    graph = trace.GraphStamps(None)
    graph.sites.append(("mctf.interp", {"level": 1}))
    trace.set_run_log(None)
    assert trace.replay_stamps(graph, "graph.analyze", "cuda:0") is None
    for only in (("graph.analyze",), ("mctf.interp",)):
        trace.set_run_log(trace.RunLog(only=only))
        try:
            assert trace.replay_stamps(graph, "graph.analyze",
                                       "cuda:0") is None
        finally:
            trace.set_run_log(None)
    trace.set_run_log(trace.RunLog())
    try:
        assert trace.replay_stamps(None, "graph.analyze", "cuda:0") is None
        assert trace.replay_stamps(trace.GraphStamps(None),
                                   "graph.analyze",
                                   "cuda:0") is None
    finally:
        trace.set_run_log(None)


def test_trace_imports_nothing_above_it():
    """``utils/trace`` is the lowest layer: the stamp kernel is handed to
    it (``utils/graphs``), so it imports nothing of the port's ops, codec
    or MCTF."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(trace))
    imported = [n.module or "" for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.level > 0]
    assert imported == [], imported
