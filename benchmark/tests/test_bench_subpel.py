"""The quarter-pel cell ``hd1080-subpel2.encode`` on the CPU at a small
size: the reference's streams equal the program's at sub-pixel accuracy,
a whole run is correct, the ``translate`` content moves by its mix's
velocity, and the interpolation's bytes and readers."""

import json

import pytest
import torch

from benchmark import interp_roofline, spec as specs
from benchmark.content import translate
from benchmark.records import Answer, Run
from benchmark.reference import encode as reference
from benchmark.reference.config import CodecConfig as RefConfig
from benchmark.tests.test_bench_run import KEYS, _run

CELL = "hd1080-subpel2.encode"
#: the mix's velocity, (y, x) pixels a frame: quarter-pel vectors
VELOCITY = {"velocity_y": 1.25, "velocity_x": 2.5}


@pytest.mark.parametrize("a", [0, 2])
def test_reference_stream_equals_the_programs_subpel(a):
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec.codestream import VideoStream
    from qsvc_tpu_torch.config import CodecConfig
    from qsvc_tpu_torch.io.yuv import Video
    kw = dict(pixels_in_x=128, pixels_in_y=64, TRLs=3, SRLs=3,
              block_size=16, search_range=4, GOPs=1, subpixel_accuracy=a)
    y, u, v = translate.make(CodecConfig(**kw).pictures, 64, 128,
                             {"content_seed": 4, **VELOCITY}, "cpu")
    prog = api.compress_chunks([Video(y, u, v)], CodecConfig(**kw),
                               reversible=False, device="cpu")[0].to_bytes()
    assert reference.encode(y, u, v, RefConfig(**kw), "cpu") == prog
    assert VideoStream.from_bytes(prog).cfg.subpixel_accuracy == a


@pytest.mark.parametrize("trace", [0, 1])
def test_subpel_cell_last_line(capsys, tiny_root, trace):
    # a traced window long enough to finish GOPs under the CPU's profiler
    rc, out, _ = _run(capsys, tiny_root, CELL, trace,
                      seconds=12 if trace else 3)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS + (["breakdown"] if trace else []) \
        + ["compared"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert {k: v["value"] for k, v in line["compared"].items()} == {
        "layout_differing": 0, "answers_missing": 0,
        "rd_cost_excess_pct": 0.0}
    cell = specs.load_cell(CELL, tiny_root)
    assert cell.config["codec"]["subpixel_accuracy"] == 2
    if trace:
        names = {m["name"] for m in cell.per_layer}
        # the one-card pipeline's layers, as in cell 1, and the
        # interpolation's; not the whole-pixel kernels' roofline
        assert names == {
            "dispatch_host_ms", "stats_wait_ms", "native_entropy_ms",
            "device_idle_share", "texture_device_ms", "mctf_device_ms",
            "upload_wait_ms", "assemble_ms", "serialize_ms", "gc_pause_ms",
            "idle_unattributed_share", "interp_device_ms",
            "interp_roofline"}
        assert {"interp_device_ms", "interp_roofline", "mctf_device_ms"} \
            <= set(line["metrics"]) <= names
        assert line["metrics"]["interp_device_ms"]["value"] > 0
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert set(line["metrics"]) == {"encode_fps", "gop_latency_p90_ms",
                                        "stream_bpp", "setup_s"}


def test_translate_is_seeded_and_moves_by_the_velocity():
    mix = {"content_seed": 77, **VELOCITY}
    y, u, v = translate.make(9, 64, 96, mix, "cpu")
    again = translate.make(9, 64, 96, mix, "cpu")
    assert all((p == q).all() for p, q in zip((y, u, v), again))
    other = translate.make(9, 64, 96, dict(mix, content_seed=78), "cpu")
    assert (other[0] != y).any()
    assert y.shape == (9, 64, 96) and u.shape == v.shape == (9, 32, 48)
    assert y.dtype == u.dtype == v.dtype == "uint8"
    # four frames move the luma by (5, 10) whole pixels on the torus, the
    # chroma by (2.5, 5): whole again after eight
    for t in range(5):
        assert (y[t + 4] == torch.from_numpy(y[t]).roll(
            (5, 10), dims=(0, 1)).numpy()).all()
    assert (u[8] == torch.from_numpy(u[0]).roll(
        (5, 10), dims=(0, 1)).numpy()).all()
    # between, the shift is fractional: no whole-pixel shift matches
    assert (y[1] != y[0]).any() and (y[1] != torch.from_numpy(y[0]).roll(
        (1, 2), (0, 1)).numpy()).any()


def test_interp_bytes_at_the_flagship_schedule():
    """The flagship's schedule at a = 2: 1920 x 1088 (HW = 2,088,960
    samples), levels 1-4 of 17, 9, 5, 3 pictures (P = 8, 4, 2, 1 pairs).
    At a level of P pairs, in units of HW int16 samples (2 bytes), each
    region reading its first input once and writing what leaves it:

    * me_up step 1: 2P + 1 lumas read (1 HW each) and written at 4 HW:
      5 (2P + 1); step 2: its input is step 1's output, written at 16 HW:
      16 (2P + 1);
    * pred_up: 3 (P + 1) planes read at 1, written at 16: 17 per plane;
    * pred_down: 3P planes read at 16, written at 1: 17 per plane.

    That is 21 (2P + 1) + 51 (P + 1) + 51 P a level.  Level 1: 85 + 272
    + 459 + 408 = 1224; level 2 (P = 4): 45 + 144 + 255 + 204 = 648;
    level 3 (P = 2): 25 + 80 + 153 + 102 = 360; level 4 (P = 1): 15 + 48
    + 102 + 51 = 216.  Sum 2448 HW samples x 2 bytes = 10,227,548,160
    bytes a GOP, 3.05 ms at 3.35 TB/s."""
    codec = specs.load_config("hd1080-subpel2")["codec"]
    HW = 1920 * 1088
    regions = interp_roofline.gop_regions(codec)
    assert [(r["level"], r["part"], r["step"]) for r in regions[:4]] == [
        (1, "me_up", 1), (1, "me_up", 2), (1, "pred_up", None),
        (1, "pred_down", None)]
    assert [r["bytes"] // (2 * HW) for r in regions[:4]] == [
        85, 272, 459, 408]
    per_level = {}
    for r in regions:
        per_level[r["level"]] = per_level.get(r["level"], 0) + r["bytes"]
    assert per_level == {1: 1224 * HW * 2, 2: 648 * HW * 2,
                         3: 360 * HW * 2, 4: 216 * HW * 2}
    assert interp_roofline.gop_bytes(codec) == 2448 * HW * 2 \
        == 10_227_548_160
    # samples written: level 1's me_up step 1 writes 17 lumas at 4 HW;
    # pred_up 27 planes at 4 HW and then at 16 HW
    assert regions[0]["samples"] == 17 * 4 * HW
    assert regions[2]["samples"] == 27 * 20 * HW
    # whole-pixel: nothing to count
    flagship = specs.load_config("hd1080-lossy")["codec"]
    assert interp_roofline.gop_regions(flagship) == []


def _analyze_spans(cfg_kw, frames):
    from qsvc_tpu_torch.config import CodecConfig
    from qsvc_tpu_torch.mctf import transform
    from qsvc_tpu_torch.utils import trace
    log = trace.RunLog()
    trace.set_run_log(log)
    try:
        transform.analyze_jit(*(torch.from_numpy(p) for p in frames),
                              CodecConfig(**cfg_kw))
    finally:
        trace.set_run_log(None)
    return [r for r in log.records if r.get("device_stage") == "mctf.interp"]


def test_schedule_counts_the_spans_bytes():
    """The program's ``mctf.interp`` spans of one GOP carry, region by
    region, the bytes and samples :mod:`benchmark.interp_roofline` counts
    from the schedule."""
    kw = dict(pixels_in_x=128, pixels_in_y=64, TRLs=4, SRLs=3,
              block_size=16, search_range=4, GOPs=1, subpixel_accuracy=2)
    frames = translate.make(RefConfig(**kw).pictures, 64, 128,
                            {"content_seed": 5, **VELOCITY}, "cpu")
    spans = _analyze_spans(kw, frames)
    regions = interp_roofline.gop_regions(kw)
    assert [(s["level"], s["part"], s.get("step"), s["samples"],
             s["bytes"]) for s in spans] == [
        (r["level"], r["part"], r["step"], r["samples"], r["bytes"])
        for r in regions]
    assert sum(s["bytes"] for s in spans) == interp_roofline.gop_bytes(kw)


def _run_with(spans, gops=2, config=None):
    run = Run(CELL, {"codec": config or specs.load_config(
        "hd1080-subpel2")["codec"]}, {}, 10.0, window_start=100.0)
    run.answers = [Answer(i, 100.0 + i, 101.0 + i, advance=16)
                   for i in range(gops)]
    run.spans = spans
    return run


def _span(level, part, seconds, ts, step=None):
    rec = {"device_stage": "mctf.interp", "level": level, "part": part,
           "samples": 1, "bytes": 1, "device_seconds": seconds,
           "start": ts - seconds, "ts": ts}
    if step is not None:
        rec["step"] = step
    return rec


def test_interp_readers_on_fabricated_logs():
    interp_ms = specs.reader("interp_device_ms")
    share = specs.reader("interp_roofline")
    codec = specs.load_config("hd1080-subpel2")["codec"]
    bounds = {(r["level"], r["part"], r["step"]): r["bytes"] / 3.35e12
              for r in interp_roofline.gop_regions(codec)}
    spans = [_span(1, "me_up", 0.004, 101.0, step=1),
             _span(1, "pred_up", 0.010, 101.5),
             _span(2, "pred_down", 0.002, 102.0),
             # ended outside the window: not read
             _span(1, "pred_up", 0.5, 120.0),
             {"device_stage": "graph.analyze", "device_seconds": 1.0,
              "start": 100.0, "ts": 101.0}]
    run = _run_with(spans)
    assert interp_ms(run) == pytest.approx((0.004 + 0.010 + 0.002) / 2
                                           * 1e3)
    want = (bounds[(1, "me_up", 1)] + bounds[(1, "pred_up", None)]
            + bounds[(2, "pred_down", None)]) / 0.016
    assert share(run) == pytest.approx(100 * want)
    # no trace: no spans, nothing to read
    untraced = _run_with([])
    assert interp_ms(untraced) is None and share(untraced) is None
    # a span of a region the schedule does not hold: no share
    assert share(_run_with([_span(9, "pred_up", 0.01, 101.0)])) is None
