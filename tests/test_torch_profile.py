"""PyTorch port: the attribution tools (``qsvc_tpu_torch/tools/profile*``)
on the CPU at a tiny size.

The tools time the card, so here only what a CPU run can show is held:
each entry refuses to run without a card; the stage splits run the
production encode (their streams are ``api.compress``'s bytes); the MCTF
tool's level-1 steps compute what ``transform.analyze`` computes, in the
port and in the JAX package (integer paths: exact); and the profile's
timeline arithmetic and the decode's loop statistics are right on
fabricated timelines and records."""

import os
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qsvc_tpu.config import CodecConfig as JaxConfig
from qsvc_tpu.mctf import transform as jtransform
from qsvc_tpu_torch import api
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.io import synthetic_video
from qsvc_tpu_torch.mctf import transform
from qsvc_tpu_torch.tools import (bench, profile, profile_decode,
                                  profile_dispatch, profile_hbm,
                                  profile_mctf, profile_pipeline,
                                  profile_stages, profile_transfer,
                                  profile_warmup)

torch.set_num_threads(1)

#: the flagship's shape of configuration at 64x64: 2 GOPs of 2 frames
TINY = dict(pixels_in_x=64, pixels_in_y=64, TRLs=2, GOPs=2, SRLs=2,
            block_size=16, search_range=4, update_factor=0.25,
            quantization_texture=45000)
TOOLS = {"profile_stages": profile_stages, "profile_mctf": profile_mctf,
         "profile_decode": profile_decode,
         "profile_pipeline": profile_pipeline,
         "profile_warmup": profile_warmup, "profile_hbm": profile_hbm,
         "profile_transfer": profile_transfer,
         "profile_dispatch": profile_dispatch}


@pytest.fixture(scope="module")
def tiny():
    cfg = CodecConfig(**TINY)
    return cfg, synthetic_video(cfg.pictures, 64, 64, seed=3,
                                kind="translate")


def _compress_gops(cfg, video):
    """``api.compress`` of each GOP of ``video``: the bytes."""
    S, gop_cfg = cfg.gop_size, cfg.replace(GOPs=1)
    return [api.compress(video[g * S:(g + 1) * S + 1], gop_cfg,
                         reversible=False, device="cpu").to_bytes()
            for g in range(cfg.GOPs)]


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_main_needs_a_card(name, capsys, tmp_path):
    """At its default device each tool exits non-zero on a host without
    a card, says so and writes nothing: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the tool would run on it")
    out = tmp_path / "out.json"
    assert TOOLS[name].main(["--out", str(out)]) != 0
    captured = capsys.readouterr()
    assert f"{name}: no CUDA device" in captured.err
    assert not captured.out
    assert not out.exists()


def test_stage_split_is_the_production_encode(tiny):
    """Both reps of ``profile_stages`` (the captured texture program whole
    and its three eager parts) give ``api.compress``'s bytes, and record
    every stage of their kind."""
    cfg, video = tiny
    row, streams = profile_stages.profile_stages(cfg, video, device="cpu")
    want = _compress_gops(cfg, video)[0]
    assert streams["graphed"] == want
    assert streams["split"] == want
    assert row["identical"] and row["bytes"] == len(want)
    assert row["profile"] is None and row["device"] == "cpu"
    common = {"upload", "analyze_jit", "decorrelate_jit",
              "device_encode+stats_fetch", "select+gather_fetch",
              "native_entropy_coding"}
    assert common | {"encode_device_jit"} <= set(row["graphed"]["stages"])
    assert common | {"dwt_quant_tile", "bp_rd_sim", "compact"} <= set(
        row["split"]["stages"])
    assert "encode_device_jit" not in row["split"]["stages"]
    for kind in ("graphed", "split"):
        listed = sum(row[kind]["stages"][n] for _, n in profile_stages.ROWS
                     if n in row[kind]["stages"])
        assert 0 < listed <= row[kind]["total_s"]


def test_split_encode_device_equals_the_program(tiny):
    """The split of ``_encode_device`` returns the fused function's
    outputs on the same inputs."""
    from qsvc_tpu_torch.codec import frame_codec
    cfg, video = tiny
    planes = torch.from_numpy(video.y[:3].astype(np.int16))
    levels, cb = 1, 64
    N, H, W = planes.shape
    tpl = frame_codec._tile_template(H, W, levels, cb)
    ms = torch.as_tensor(frame_codec._slope_floor(
        np.full(N, 10.0), N, len(tpl), tpl, False, 1.5, "bp"))
    args = (planes, torch.tensor(1.5), *frame_codec._tile_dims_on(
        H, W, levels, cb, N, "cpu"), ms, levels, False, cb)
    got = profile_stages._split_encode_device("cpu")(*args)
    want = frame_codec._encode_device(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pipeline_streams_are_the_production_encode(tiny):
    """(a), (b2) and (c) of ``profile_pipeline`` give ``api.compress``'s
    bytes of their GOPs."""
    cfg, video = tiny
    row, streams = profile_pipeline.profile_pipeline(cfg, video,
                                                     device="cpu", reps=1)
    want = _compress_gops(cfg, video)
    assert streams["one_gop"] == want[0]
    assert streams["dispatch_finish"] == want[row["dispatch_finish_gop"]]
    assert streams["pipelined"] == want
    assert len(row["one_gop_s"]) == len(row["analyze_fetch1_s"]) == 1
    assert len(row["pipelined_fps"]) == 2


@pytest.mark.parametrize("subpel", [0, 2])
def test_mctf_level1_equals_analyze(tiny, subpel):
    """``profile_mctf``'s level-1 steps give the level-1 high bands,
    motion field and frame types, and the low band (the final one at
    TRLs 2), of the port's ``transform.analyze`` and of the JAX
    package's ``analyze_jit`` on the same seeded frames: exact."""
    cfg, video = tiny
    cfg = cfg.replace(subpixel_accuracy=subpel)
    row, out = profile_mctf.profile_mctf(cfg, video, device="cpu", reps=1)
    gop_cfg = cfg.replace(GOPs=1)
    planes = [p[:cfg.gop_size + 1] for p in video.planes()]
    port = transform.analyze(*(torch.from_numpy(p) for p in planes),
                             gop_cfg)
    jax_stream = jtransform.analyze_jit(
        *(jnp.asarray(p) for p in planes),
        JaxConfig(**dict(TINY, GOPs=1, subpixel_accuracy=subpel)))
    got = [t.numpy() for t in (*out["level"], *out["low"])]
    for ref in (port, jax_stream):
        want = [np.asarray(a) for a in (*ref.levels[0], ref.low_y,
                                        ref.low_u, ref.low_v)]
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.array_equal(g, w)
    labels = [r["label"] for r in row["rows"]]
    assert any("K1" in k for k in labels) and any("K3" in k for k in labels)
    assert any("K4" in k for k in labels)
    assert any("upsample2" in k for k in labels) == bool(subpel)


# -- the profile's timeline arithmetic ---------------------------------------

def test_merge_covered_and_gaps():
    iv = [(5.0, 6.0), (1.0, 2.0), (1.5, 3.0), (3.0, 3.5), (8.0, 9.0)]
    assert profile.merge(iv) == [(1.0, 3.5), (5.0, 6.0), (8.0, 9.0)]
    assert profile.covered(iv) == pytest.approx(4.5)
    # the window [0, 10): a gap before the first interval and after the
    # last, longest first
    assert profile.idle_gaps(iv, 0.0, 10.0) == [
        (6.0, 8.0), (3.5, 5.0), (0.0, 1.0), (9.0, 10.0)]
    assert profile.idle_gaps(iv, 1.2, 5.5) == [(3.5, 5.0)]
    assert profile.clip(iv, 2.5, 5.5) == [(5.0, 5.5), (2.5, 3.0),
                                          (3.0, 3.5)]


def test_gap_labels_take_the_innermost_stage():
    """Nested stages: the inner one takes the instants it covers, its
    parent the rest; a gap before the first stage is the no-stage
    label's."""
    stages = [("outer", 1.0, 9.0), ("inner", 2.0, 4.0),
              ("inner2", 2.0, 3.0), ("later", 9.0, 10.0)]
    split = profile.innermost_split((1.5, 5.0), stages)
    assert split == pytest.approx({"outer": 1.5, "inner2": 1.0,
                                   "inner": 1.0})
    assert profile.innermost_split((0.0, 1.0), stages) == {
        profile.NO_STAGE: 1.0}
    gaps = [(0.0, 0.5), (1.5, 5.0), (8.5, 9.5)]
    rows = profile.label_gaps(gaps, stages, origin=0.0, n=2)
    assert [r["stage"] for r in rows] == ["outer", "outer"]
    assert [r["seconds"] for r in rows] == [3.5, 1.0]
    assert rows[1]["stages"] == pytest.approx({"outer": 0.5, "later": 0.5})
    first = profile.label_gaps(gaps, stages, origin=0.0, n=3)[2]
    assert first["start"] == 0.0 and first["stage"] == profile.NO_STAGE


def test_window_summary_on_a_fabricated_timeline():
    """Busy share, op aggregation and counts, kernel counts, the gaps'
    stages (records moved onto the profiler's clock) and the window's
    share outside every stage."""
    ops = [("void me_refine_kernel<true>(short const*, int)", 10.0, 10.5),
           ("void me_refine_kernel<true>(short const*, int)", 10.5, 11.0),
           ("void mc_update_kernel<2>(short const*, int)", 12.0, 13.5),
           ("Memcpy HtoD (Pageable -> Device)", 11.5, 12.3),
           ("void mc_predict_kernel(short const*)", 16.0, 16.6),
           ("void at::native::elementwise_kernel<128, 4>(int)", 30.0, 31.0)]
    # host clock = profiler clock - 100; records end at ts after seconds
    records = [{"stage": "analyze", "ts": -88.0, "seconds": 2.0},
               {"stage": "fetch", "ts": -85.0, "seconds": 2.0},
               {"stage": "other"}]
    w = profile.window_summary(ops, records, 10.0, 20.0, 100.0, top=3,
                               n_gaps=2)
    assert w["wall_s"] == 10.0
    assert w["busy_s"] == pytest.approx(3.6)
    assert w["busy_share"] == pytest.approx(0.36)
    assert w["device_ops"] == 5
    assert [(o["name"], o["count"]) for o in w["top_ops"]] == [
        ("mc_update_kernel<2>", 1), ("me_refine_kernel<true>", 2),
        ("Memcpy HtoD (Pageable -> Device)", 1)]
    assert [o["seconds"] for o in w["top_ops"]] == pytest.approx(
        [1.5, 1.0, 0.8])
    assert w["kernels"] == {"me_refine": 2, "mc_predict": 1,
                            "mc_update2": 1, "mc_update1": 0,
                            "bp_slope": 0}
    gaps = [(g["start"], g["seconds"], g["stage"]) for g in w["gaps"]]
    assert [g[2] for g in gaps] == [profile.NO_STAGE, "fetch"]
    assert [g[:2] for g in gaps] == [pytest.approx((6.6, 3.4)),
                                     pytest.approx((3.5, 2.5))]
    assert w["gaps"][1]["stages"] == pytest.approx({"fetch": 1.5,
                                                    profile.NO_STAGE: 1.0})
    assert w["stages_s"] == {"analyze": 2.0, "fetch": 2.0}
    assert w["staged_s"] == pytest.approx(4.0)
    assert w["unstaged_share"] == pytest.approx(0.6)


def test_outermost_stages_count_nested_spans_once():
    """A stage inside another (``upload`` in ``upload+mctf_dispatch``, a
    collection inside anything) is part of its parent's time; stages that
    only touch or overlap are each counted."""
    stages = [("upload+mctf_dispatch", 0.0, 4.0), ("upload", 1.0, 2.0),
              ("gc.collect", 1.5, 1.6), ("texture_dispatch", 4.0, 6.0),
              ("texture_args_upload", 4.0, 5.0), ("other", 5.5, 7.0)]
    assert profile.outermost_seconds(stages) == pytest.approx(7.5)
    assert profile.outermost_seconds([]) == 0.0
    w = profile.window_summary([], [
        {"stage": n, "ts": b - 100.0, "seconds": b - a}
        for n, a, b in stages], 0.0, 10.0, 100.0)
    assert w["stages_sum_s"] == pytest.approx(9.6)
    assert w["stages_outer_s"] == pytest.approx(7.5)


def test_short_names_and_resolution():
    assert profile.short_name(
        "void mc_update_kernel<2>(short const*, int*)") == \
        "mc_update_kernel<2>"
    assert profile.short_name("Memcpy DtoH (Device -> Pinned)") == \
        "Memcpy DtoH (Device -> Pinned)"
    assert profile.short_name(
        "void at::native::(anonymous namespace)::f<std::array<char*, 3>>"
        "(int)") == "f<array<char*, 3>>"
    window = {"kernels": {"me_refine": 56, "mc_predict": 16},
              "launches": {"me_refine": 56, "mc_predict": 16}}
    assert profile.resolved(window)
    window["kernels"]["me_refine"] = 0
    assert not profile.resolved(window)


def test_device_profile_fails_unless_the_graphs_resolve(monkeypatch):
    """One window: where the profiler saw fewer launches of a kernel of
    ``csrc/`` than the wrappers counted, the profile exits with a
    message instead of reading another window."""
    win = {"kernels": {"me_refine": 56, "mc_predict": 16},
           "launches": {"me_refine": 56, "mc_predict": 16}}
    calls = []
    monkeypatch.setattr(profile, "window",
                        lambda fn: calls.append(fn) or dict(win))
    monkeypatch.setattr(profile, "device_name", lambda device: "card, 1 W")
    out = profile.device_profile("fn")
    assert out["device"] == "card, 1 W" and calls == ["fn"]
    win["kernels"] = {"me_refine": 0, "mc_predict": 16}
    with pytest.raises(SystemExit, match="not resolved"):
        profile.device_profile("fn")
    assert calls == ["fn", "fn"]


def test_smi_lines_and_their_summary():
    """``nvidia-smi``'s CSV lines with their own timestamps, and the
    min / median / max of the samples inside a window."""
    t, fields = profile.parse_smi_line(
        "2026/10/17 19:21:42.125, NVIDIA H100 80GB HBM3, 700.00, 1980, "
        "251.37, 41\n")
    assert fields == ["NVIDIA H100 80GB HBM3", "700.00", "1980", "251.37",
                      "41"]
    from datetime import datetime
    assert t == datetime(2026, 10, 17, 19, 21, 42, 125000).timestamp()
    assert profile.parse_smi_line("No devices were found") is None
    assert profile.parse_smi_line("x, a, b, c, d, e") is None
    smi = profile.SmiSampler("GPU-test")
    smi.samples = [(1.0, ["H100", "700.00", "1755", "120.0", "40"]),
                   (2.0, ["H100", "700.00", "1980", "300.0", "[N/A]"]),
                   (3.0, ["H100", "700.00", "1900", "250.0", "44"]),
                   (9.0, ["H100", "700.00", "210", "70.0", "30"])]
    assert smi.summary(1.5, 3.5) == {
        "samples": 2, "name": "H100", "power_limit_w": "700.00",
        "clocks_sm_mhz": [1900.0, 1940.0, 1980.0],
        "power_draw_w": [250.0, 275.0, 300.0],
        "temperature_c": [44.0, 44.0, 44.0]}
    assert smi.summary(4.0, 5.0) == {"samples": 0}


def test_sampler_is_one_process_for_the_window(tmp_path, monkeypatch):
    """The sampler starts one ``nvidia-smi -lms`` on the card it was
    given, begins once a sample is in, and ends the process on exit (a
    stand-in ``nvidia-smi`` on the PATH prints timestamped lines)."""
    log = tmp_path / "argv.txt"
    fake = tmp_path / "nvidia-smi"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "while True:\n"
        "    t = time.time()\n"
        "    ms = int(t * 1000) % 1000\n"
        "    stamp = time.strftime('%Y/%m/%d %H:%M:%S', time.localtime(t))\n"
        "    print(f'{stamp}.{ms:03d}, H100, 700.00, 1980, 250.0, 40',\n"
        "          flush=True)\n"
        "    time.sleep(0.02)\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    with profile.SmiSampler("GPU-test", period_ms=20) as smi:
        assert smi.samples
        t0 = time.time()
        time.sleep(0.2)
        t1 = time.time()
    assert smi._proc.poll() is not None
    argv = log.read_text().splitlines()
    assert len(argv) == 1
    assert argv[0].split()[:2] == ["-i", "GPU-test"]
    assert "-lms 20" in argv[0]
    row = smi.summary(t0 - 0.05, t1)
    assert row["samples"] >= 3 and row["clocks_sm_mhz"] == [1980.0] * 3


def test_median_seconds_and_staged_gops(tiny):
    """One warm-up call then ``reps`` timed ones, the last result kept;
    the staged GOP chunks are the video's GOPs, each with the next one's
    first frame."""
    calls = []
    seconds, out = profile.median_seconds(lambda: calls.append(1) or
                                          len(calls), 3, "cpu")
    assert out == 4 and len(calls) == 4 and seconds >= 0
    cfg, video = tiny
    staged = bench.staged_gops(video, cfg, "cpu")
    S = cfg.gop_size
    assert len(staged) == cfg.GOPs
    for g, chunk in enumerate(staged):
        for got, want in zip(chunk.planes(), video.planes()):
            assert np.array_equal(got.numpy(), want[g * S:(g + 1) * S + 1])


def test_decode_loop_statistics_on_fabricated_records():
    """Per stage median, range and spread over the loops, a stage absent
    from a loop counted 0 there, the rest outside every stage, and the
    swing named by the widest range."""
    loops = [{"wall_s": 1.0, "stages": {"decode.native": 0.5,
                                        "decode.pack": 0.1}},
             {"wall_s": 2.0, "stages": {"decode.native": 1.4,
                                        "decode.pack": 0.2}},
             {"wall_s": 1.2, "stages": {"decode.native": 0.6}}]
    st = profile_decode.loop_stats(loops)
    assert st["loops"] == 3
    assert st["wall"] == pytest.approx({"median": 1.2, "min": 1.0,
                                        "max": 2.0, "range": 1.0,
                                        "spread": 1.0 / 1.2})
    native = st["stages"]["decode.native"]
    assert native["median"] == pytest.approx(0.6)
    assert native["range"] == pytest.approx(0.9)
    assert native["spread"] == pytest.approx(1.5)
    assert st["stages"]["decode.pack"]["median"] == pytest.approx(0.1)
    assert st["stages"]["decode.pack"]["min"] == 0.0
    outside = st["stages"][profile_decode.OUTSIDE]
    assert (outside["min"], outside["max"]) == pytest.approx((0.4, 0.6))
    assert st["swing"] == "decode.native"
    assert profile_decode.spread([0.0, 0.0])["spread"] is None


def test_decode_loops_on_the_cpu(tiny):
    """The tool's loop on the CPU: one record per loop with the decode's
    stages, their statistics, and no device profile."""
    cfg, video = tiny
    row = profile_decode.profile_decode(cfg, video, device="cpu", loops=2)
    assert len(row["per_loop"]) == 2 and row["gops"] == cfg.GOPs
    assert row["profile"] is None
    for lp in row["per_loop"]:
        assert {"decode.native", "decode.idwt_dispatch",
                "decode.synthesize_dispatch"} <= set(lp["stages"])
        assert sum(lp["stages"].values()) <= lp["wall_s"]
    assert row["stats"]["swing"] in row["stats"]["stages"]


def test_warmup_steps_on_the_cpu(tiny):
    """The cold-start split's steps in the order they are paid (a fresh
    interpreter's imports first, the PSNR last); on the CPU no graph is
    captured."""
    cfg, video = tiny
    row = profile_warmup.profile_warmup(cfg, lambda: video, device="cpu")
    steps = [r["step"] for r in row["rows"]]
    assert steps[0] == "import torch (fresh interpreter)"
    assert steps[-1] == "video_psnr"
    assert steps.index("api.prewarm") < steps.index(
        "first compress_gops after the prewarm") < steps.index(
        "api.prewarm_decode") < steps.index(
        "first expand_gops after the prewarm")
    assert row["total_s"] == pytest.approx(sum(r["seconds"]
                                               for r in row["rows"]))
    assert row["encode_graphs"] == row["graphs_after_prewarm"] == []


def test_hbm_rows_compute_their_functions():
    """The JAX tool's 8 rows and the two stream rows at a tiny size on the
    CPU: their functions and the bytes they must move."""
    rows = profile_hbm.rows("cpu", n=64, side=4, frame=(2, 3, 5), tiles=2)
    assert len(rows) == 10
    values = {label: fn(x).clone() for label, fn, x, _ in rows}
    for label, out in values.items():
        if "a*2+1" in label:
            assert torch.all(out == 3)
    assert torch.all(values["2D f32 sum-rows"] == 4)
    assert values["2D f32 sum-all"].item() == 16
    assert torch.all(values["2x3x5 i32 chain of 10 adds"] == 56)
    # ones: bit 0 set in every pixel, bits 1-3 clear
    assert torch.all(values["sim-like 4 planes over 2 tiles i16"] == 4096)
    assert torch.all(values["stream copy f32"] == 1)
    assert torch.all(values["stream scale f32"] == 2)
    assert [nb for *_, nb in rows] == [512, 256, 256, 128, 64, 64, 240,
                                       65536, 512, 512]
