"""The metrics, computed on fabricated records and timelines; the
roofline's bounds against hand counts at the flagship's shapes."""

import pytest

from benchmark import roofline, spec as specs, timeline
from benchmark.records import Answer, Run, Trace

FLAGSHIP = specs.load_config("hd1080-lossy")["codec"]


def stream_run(done_times, taken_times, nbytes=1000, seconds=10.0):
    run = Run("c", {"codec": dict(FLAGSHIP)},
              {"entry": "compress_chunks"}, seconds, window_start=100.0)
    run.answers = [Answer(0, t0, t1, 17, 1920 * 1088, nbytes, advance=16)
                   for t0, t1 in zip(taken_times, done_times)]
    return run


def read(name, run):
    return specs.reader(name)(run)


def test_encode_fps_counts_the_window_pro_rata():
    # finishes at 101, 102, ..., 109 inside, 110.5 after the end (110)
    done = [101.0 + i for i in range(9)] + [110.5]
    run = stream_run(done, [t - 0.4 for t in done])
    # 9 inside, the tenth half inside: (110 - 109) / (110.5 - 109)
    assert read("encode_fps", run) == pytest.approx(
        16 * (9 + 1 / 1.5) / 10.0)


def test_gop_latency_p90_over_the_window():
    done = [101.0 + i for i in range(10)]
    lat = [0.1 * (i + 1) for i in range(10)]      # 0.1 .. 1.0 s
    run = stream_run(done, [d - l for d, l in zip(done, lat)])
    # 10 GOPs finished inside (the last at 110.0 <= end); p90 linear
    assert read("gop_latency_p90_ms", run) == pytest.approx(910.0)


def test_stream_bpp():
    run = stream_run([101.0, 102.0, 111.0], [100.5, 101.5, 110.5],
                     nbytes=2000)
    # the two finished inside: 2 * 2000 * 8 bits over 2 * 17 frames
    assert read("stream_bpp", run) == pytest.approx(
        32000 / (34 * 1920 * 1088))


def test_sharded_fps():
    run = Run("c", {"codec": dict(FLAGSHIP)},
              {"entry": "compress_distributed"}, 4.0, window_start=0.0)
    run.answers = [Answer(0, t, t + 1.0, 129, 1, advance=129)
                   for t in (0, 1, 2, 3)]
    assert read("sharded_fps", run) == pytest.approx(129 * 4 / 4.0)
    # answers that move no feed forward give no rate to read
    for a in run.answers:
        a.advance = 0
    assert read("sharded_fps", run) is None


def test_idle_share_and_gaps():
    ops = [("k", 0.0, 1.0), ("k", 0.5, 2.0), ("k", 3.0, 4.0)]
    run = stream_run([], [])
    run.trace = Trace(0.0, 5.0, ops, 2)
    # busy 0-2 and 3-4: 3 of 5 s
    assert read("device_idle_share", run) == pytest.approx(40.0)
    spans = [{"stage": "native_entropy_coding", "ts": 3.0, "seconds": 1.5}]
    gaps = timeline.labelled_gaps(ops, spans, 0.0, 5.0)
    assert gaps == [["native_entropy_coding", 1.0], ["_no_stage_", 1.0]]
    assert timeline.top_ops(ops, 0.0, 5.0) == [["k", 3.5]]


def test_span_readers_per_gop():
    run = stream_run([], [])
    run.spans = [{"stage": "upload+mctf_dispatch", "ts": 101, "seconds": .1},
                 {"stage": "texture_dispatch", "ts": 101.1, "seconds": .02},
                 {"stage": "upload+mctf_dispatch", "ts": 102, "seconds": .1},
                 {"stage": "texture_dispatch", "ts": 102.1, "seconds": .02},
                 {"stage": "native_entropy_coding", "ts": 103,
                  "seconds": .01},
                 {"stage": "native_entropy_coding", "ts": 120,
                  "seconds": 9}]      # after the window: not read
    assert read("dispatch_host_ms", run) == pytest.approx(120.0)
    assert read("native_entropy_ms", run) == pytest.approx(10.0)
    assert read("stats_wait_ms", run) is None


def test_roofline_bytes_against_hand_counts():
    seq = roofline.gop_launches(FLAGSHIP)
    names = [k for k, _ in seq]
    assert names.count("me_refine") == 14
    assert names.count("mc_predict") == names.count("mc_update2") == 4
    # level 1 (8 pairs): K2 reads two 4:4:4 int16 stacks, writes one
    plane = 8 * 3 * 1088 * 1920
    mv = 8 * 2 * 2 * 17 * 30 * 4
    k2 = seq[names.index("mc_predict")][1]
    assert k2 == pytest.approx((3 * 2 * plane + mv) / 3.35e12)
    # K3 reads int16 contributions, writes two int32 directions
    k3 = seq[names.index("mc_update2")][1]
    assert k3 == pytest.approx((2 * plane + mv + 8 * plane) / 3.35e12)
    # K1 at level 1, depth 0: three int16 lumas, the vectors in and out
    k1 = seq[1][1]
    assert k1 == pytest.approx(
        (3 * 8 * 1088 * 1920 * 2 + 2 * mv) / 3.35e12)
    # PERF.md's kernel table: 0.0898 / 0.1497 / 0.0300 ms
    assert (round(k2 * 1e3, 4), round(k3 * 1e3, 4), round(k1 * 1e3, 4)) \
        == (0.0898, 0.1497, 0.03)


def test_roofline_share_matches_whole_gops():
    seq = roofline.gop_launches(FLAGSHIP)
    names = {"me_refine": "void me_refine_kernel<64>(...)",
             "mc_predict": "void mc_predict_kernel(...)",
             "mc_update2": "void mc_update_kernel<2>(...)"}
    ops, t = [], 0.0
    # a partial GOP (its last 3 launches), two whole GOPs, then 2 more
    order = seq[-3:] + seq + seq + seq[:2]
    for k, bound in order:
        ops.append((names[k], t, t + 2 * bound))   # each at half its bound
        t += 2 * bound + 1e-6
    ops.append(("other_kernel", 0.0, t))
    assert roofline.roofline_share(ops, FLAGSHIP) == pytest.approx(0.5)
    run = stream_run([], [])
    run.trace = Trace(0.0, t, ops, 3)
    assert read("mctf_kernels_roofline", run) == pytest.approx(50.0)


def test_roofline_silent_off_the_sequence():
    ops = [("void mc_predict_kernel(...)", 0.0, 1.0)] * 3
    assert roofline.roofline_share(ops, FLAGSHIP) is None
    assert roofline.roofline_share([], FLAGSHIP) is None


def test_halo_exchange_per_call():
    run = Run("c", {"codec": dict(FLAGSHIP)},
              {"entry": "compress_distributed"}, 10.0)
    run.trace = Trace(0.0, 4.0, [("ncclDevKernel_SendRecv(x)", 1.0, 1.2),
                                 ("ncclDevKernel_SendRecv(x)", 2.0, 2.3),
                                 ("other", 0.0, 4.0)], 2)
    assert read("halo_exchange_ms", run) == pytest.approx(250.0)
