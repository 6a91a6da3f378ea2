"""Smoke run of the PyTorch/CUDA port (``qsvc_tpu_torch``) on one GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the last line:

1. set-up: the card's name and power limit, then the build of the CUDA
   kernels (``qsvc_tpu_torch/csrc``) and of the native EBCOT coder;
2. kernel parity at the flagship shapes: K1 (spiral SAD refinement) at
   each of its 14 calls in one GOP (every pyramid depth of temporal
   levels 1-4), then at level 1, depth 0 over the full int16 range (its
   wrap-around path), timed as CUDA-graph replays (device time) and back
   to back, beside one CTA per block (no cluster), with its summed time
   and bound per GOP; K2 (MC predict), K3
   (MC update, both directions) and K4 (MC update, one direction, each
   direction) at 8 pairs of 1088x1920x3 with random vectors up to
   search range 32 + 1, then at each flagship level's own call, (pairs,
   search range) = (8, 4), (4, 8), (2, 16), (1, 32), with the vectors of
   one MCTF analysis of phase 4's first GOP and with random vectors up
   to search range + 1, and at each level of phase 8d's scaling
   configuration (512x512, block 32: (2, 4) and (1, 8)) with that run's
   own vectors and random ones — each kernel against its plain PyTorch
   version on the same card, exact equality, with CUDA-event times
   (batches of calls back to back, after a warm-up) beside the kernel's
   bound; then
   K1 where its window is wider: the sub-pixel calls of a flagship GOP
   at accuracies 1-3 (blocks of 128, 256 and 512 on frames interpolated
   2, 4 and 8 times, at each level's pairs and cap), one block of 1024
   and borders 1-4 at level 1, with the per-GOP sums at each accuracy;
   and K2 at the sub-pixel prediction's blocks of 64 << a, a = 1-3 (at
   a = 3 the plain version runs on 2 of the 8 pairs, for memory); then
   K2 and K3 at the calls of a decode reduced by SS at d = 1-4 (blocks of
   32, 16, 8 and 4 on frames of 1088x1920 >> d), timed beside their
   bounds;
3. correctness on the card: the MCTF analysis and synthesis of a small
   sequence on the card, eager and as the captured programs
   ``analyze_jit``/``synthesize_jit``, equal the plain CPU run,
   whole-pixel, at sub-pixel accuracies 1-3, with OLA (alone and with
   a = 1) and with a border of 2, and a 1080p lossless 5/3 MCTF stream
   round-trips bit-exactly through its container bytes;
4. the flagship: 1920x1088, GOP 16 (TRLs=5), 9/7 at slope 45000, 4 GOPs
   staged on the card, encoded (warm-up + timed) and decoded to
   device-resident uint8 through the API (so through its captured
   programs), with the kernel launch counts of that run and of the timed
   encode and decode, and the peak device memory;
5a. the sharded flagship on one rank (``qsvc_tpu_torch.parallel``): the
   phase 4 configuration as one 65-frame sequence, ``compress_distributed``
   byte-identical to ``api.compress`` and ``encode_gops_distributed`` to
   ``api.compress_gops``; that encode launches K4 and not K3; warm wall
   times of the sharded and the sequential encode, for information;
5b. the halo exchange on the card: a ``gloo`` group of 2 spawned
   processes, both on this card (NCCL takes one rank per card), encodes
   2 GOPs of 1920x1088 losslessly; both ranks' ``compress_distributed``
   bytes equal the sequential encode's, their ``synthesize_sharded``
   frames equal the sequential synthesis, and each rank launched K4;
5c. where several cards are visible, the nccl check of
   ``tools/nccl_halo.py`` across all of them, one rank per card: the
   flagship's 4 GOPs lossy, at sub-pixel accuracy 2 and lossless,
   every rank's ``compress_distributed`` == ``api.compress``, and the
   lossless run's ``synthesize_sharded`` == ``transform.synthesize`` and
   ``encode_gops_distributed`` == ``api.compress_gops``; on one card it
   says so and runs nothing;
6. the sub-pixel flagship: phase 4's run at sub-pixel accuracy 2 (4
   GOPs, fps, bpp, PSNR and launches; fails if K1-K3 never launch or
   PSNR-Y < 25 dB), then one GOP at accuracy 3 with OLA (block_overlaping
   8) and border_size 2, lossless, which must round-trip bit-exactly
   through its container bytes;
7. the codec's user surface: (a) ``qsvc_tpu_torch.cli`` in this process
   on 33 frames (2 GOPs) of the flagship's video through a .yuv file —
   lossless compress with a resume store, again (both GOPs from the
   store), expand byte for byte; lossy compress at 45000, info, transcode
   (QS 46000 smaller, TS and SS expanded to their shapes), rd of two
   points; (b) a lossless 5/3 flagship GOP reduced by SS at d = 1 and 4
   (K2 and K3 at blocks of 32 and 4) and TS at d = 1, decoded on the card
   and on the CPU, bit-identical, and FS rate control at a third of a
   lossy GOP's bytes; (c) one flagship GOP through the cp, zlib (exact at
   update 0) and ltw (PSNR-Y >= 25 dB) texture backends, with the
   launches of their encodes;
8. the rest of the JAX package's surface at the flagship's width: (a)
   the Haar, 13/7 and S+P banks at 4 levels over 17 lumas (exact round
   trips, card == CPU on 2 frames, ms and device operations per call),
   Haar up/downsampling of the chroma and ``border.pad_edge``; (b)
   ``estimate_pair`` (K1) and ``decorrelate_pair``/``correlate_pair``
   (K2) on one triple, card == CPU, the odd frame back exactly; (c) the
   spec MQ/Tier-1 coder against the native one on 64 quantized 32x32
   code-blocks of all four bands; (d) ``measure_scaling`` at n = 1 (K4
   in a spawned rank) at the JAX default configuration and at the
   flagship's, and over nccl across every card where there are several;
   (e) the dense two-stage encode against ``_dwt_quant``, int16 and the
   int32 overflow path;
9. the captured programs (``qsvc_tpu_torch/utils/graphs.py``) at the
   flagship size: (a) ``analyze_jit``, the texture stage 1,
   ``decorrelate_jit``, ``correlate_jit``, ``_dequant_idwt_jit`` and
   ``synthesize_jit`` at ``discard_TRLs`` 0 and 1, each equal to its
   eager function bit for bit on GOP 1 (first call: warm-up, capture,
   replay) and on GOP 2 through GOP 1's graphs (stale inputs), GOP 1's
   results unchanged after GOP 2's replays (aliasing), with each key's
   capture seconds and the first calls' peak memory; (b) the launches of
   one 4-GOP encode and decode through the graphs equal those of the
   eager programs (and the bytes), ``expand_gops`` in its two threads
   equals the serial ``expand``, and the decode's device busy share and
   host launches under ``torch.profiler``, replayed and eager in turns;
10. the JAX contract and the cold start at the flagship size: (a) each
   function of the port that shares a name with a JAX function whose
   arguments or shapes once differed (``histogram_entropy``,
   ``predict_frame``, ``refs_to_444``, ``predict_frames_subpixel``,
   ``decorrelate_from_pred``, ``correlate_from_pred``,
   ``residue_to_444``, ``gather_block_patches``, ``blocks_to_image``,
   ``encode_frames_select_sparse``, ``decode_frames``), called the JAX
   way on the card, equal to the CPU call (the float32 entropy within
   rtol 1e-6), ``predict_frame`` through K2; (b) the first flagship
   GOP's encode and decode walls after ``graphs.clear()``, without and
   with ``api.prewarm`` / ``prewarm_decode`` in turns, with the graphs
   that GOP captured (none after a prewarm, or the run fails); (c)
   ``api.compress(video, cfg)`` without ``device`` runs on the card;
11. the port's measurement entries (``qsvc_tpu_torch/tools``): (a)
   ``python3 -m qsvc_tpu_torch.tools.bench`` in a process of its own,
   which must exit 0 with the keys of the JAX package's ``bench.py`` (its
   two tunnel keys renamed) and with phase 4's bpp and PSNR-Y, its row
   printed on a line of its own; (b) meanwhile the RD harness's curves
   of ``translate_int`` and ``translate_frac``, both coders, on the card,
   each MCTF point within 1 % of the CPU's bytes and 0.05 dB of its
   PSNR-Y, K1-K3 launched, and ``translate_int``'s two mid-rate points
   at least 2.0 dB (mq) and 0.5 dB (bp) above OpenJPEG-intra at the same
   rate.

The whole run takes 190-340 s on an H100 (phase 9 about 36 s).

The second-to-last line is a JSON object with one entry per kernel
(launches counted on that kernel's main paths: phase 4 for K1-K3, phase
5a for K4, plus phase 8's K1, K2 and K4 paths; a graph replay counts the
launches its capture recorded, and the eager warm-up before a capture
counts as the run it is; times and bound at the first shape phase 2
names for it);
the last line is ``{"ok": true, "device": {...}}`` with the number of
visible cards.  Without a CUDA device the script exits 1 and
prints no result.

A kernel's bound is the least time the card could take for its work:
the larger of the bytes it must move (each input read once, each output
written once) over the H100's 3.35 TB/s, and its operations over their
rate below: int32 for K2-K4, and for K1 two fp32 lane operations per SAD
term (a subtraction and an addition of an absolute value, exact in fp32
while no int16 difference wraps).  No single PyTorch call computes
K1-K4, so ``library_ms`` is null.
"""

import collections
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNEL_SOURCES = {
    "me_refine": ("qsvc_tpu_torch/csrc/me_refine.cu",
                  "qsvc_tpu/ops/pallas_me.py:141"),
    "mc_predict": ("qsvc_tpu_torch/csrc/mc.cu",
                   "qsvc_tpu/ops/pallas_mc.py:144"),
    "mc_update2": ("qsvc_tpu_torch/csrc/mc.cu",
                   "qsvc_tpu/ops/pallas_mc.py:224"),
    "mc_update1": ("qsvc_tpu_torch/csrc/mc.cu",
                   "qsvc_tpu/ops/pallas_mc.py:297"),
}
#: the names phase 2 prints for the MC kernels
_SHORT = {"mc_predict": "K2", "mc_update2": "K3", "mc_update1": "K4"}
#: the kernels the sequential flagship (phase 4) must launch; K4 runs on
#: the sharded path (phase 5a)
SEQUENTIAL_KERNELS = ("me_refine", "mc_predict", "mc_update2")
#: H100 SXM device memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: int32 operations per second outside the tensor cores: 132 SMs x 64
#: INT32 lanes x 1.98 GHz (the clock of the data sheet's 67 TFLOP/s fp32,
#: 132 x 128 lanes x 2 flops)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: fp32 lane operations per second: 132 SMs x 128 FP32 lanes x 1.98 GHz
FP32_OPS_PER_S = 132 * 128 * 1.98e9
#: (pairs, search range) of the flagship's temporal levels 1-4
FLAGSHIP_LEVELS = ((8, 4), (4, 8), (2, 16), (1, 32))
#: the flagship's frame and block size
FLAGSHIP_H, FLAGSHIP_W, FLAGSHIP_BS = 1088, 1920, 64
#: the keys of ``python3 -m qsvc_tpu_torch.tools.bench``'s row: those of
#: the JAX package's ``bench.py``, its two tunnel keys renamed
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"} | {
    f"detail.{k}" for k in (
        "frames", "gops", "seconds", "warmup_seconds", "prewarm_seconds",
        "e2e_fps", "bpp", "psnr_y", "psnr_u", "psnr_v", "decode_fps",
        "decode_e2e_fps", "decode_prewarm_seconds", "device")}
#: the least mid-rate advantage of MCTF over OpenJPEG-intra on
#: ``translate_int`` by coder, dB (the bounds of tests/test_rd_anchor.py)
RD_MIN_ADVANTAGE = {"mq": 2.0, "bp": 0.5}
#: phase 3's MCTF configurations (over 256x128, block 32, search 8)
MCTF_CASES = {"whole-pixel": {}, "a=1": dict(subpixel_accuracy=1),
              "a=2": dict(subpixel_accuracy=2),
              "a=3": dict(subpixel_accuracy=3),
              "OLA d=4": dict(block_overlaping=4),
              "OLA d=4 a=1": dict(block_overlaping=4, subpixel_accuracy=1),
              "border 2": dict(border_size=2)}


def _ceil_half(x, times):
    for _ in range(times):
        x = (x + 1) // 2
    return x


def _cuda_ms(fn, reps=5, batch=10, warmup=2):
    """Time of one call: the median over ``reps`` runs of the CUDA-event
    time of ``batch`` calls back to back, divided by ``batch``, after a
    warm-up.  Back to back, the card does not wait for the wrapper's host
    work unless that takes longer than the kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def _max_err(a, b):
    if torch.equal(a, b):           # no temporaries for the large stacks
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _graph_ms(fn, calls=20, reps=5):
    """Device time of one call: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times; the median CUDA-event time of a
    replay over ``calls``.  Unlike :func:`_cuda_ms` it holds no host
    time, however short the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _bound(nbytes, ops, ops_per_s=INT32_OPS_PER_S):
    """(bound_ms, bound_by) of a kernel call: the larger of its bytes over
    the memory rate and its operations over ``ops_per_s``."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase_setup():
    from qsvc_tpu_torch.codec import fast
    from qsvc_tpu_torch.ops import cuda_lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t_cuda = cuda_lib.build_seconds()
    t_native = fast.build_seconds()
    regs = [ln.strip() for ln in cuda_lib.build_log.splitlines()
            if "registers" in ln]
    print(f"phase 1 set-up: ok, kernels built in {t_cuda:.3f} s, native "
          f"coder in {t_native:.3f} s; ptxas: {' | '.join(regs)}",
          flush=True)
    return smi


def _k1_row(label, planes, mv, bs, border, ny, nx, cap, refine,
            variants=None, eager=True):
    """K1 at one call: exact against ``me._refine_level``, device time as
    CUDA-graph replays, back-to-back time (if ``eager``), the plain
    version's time and the bound; prints one line, returns its dict."""
    from qsvc_tpu_torch.mctf import me
    pr, pv, nxt = planes
    P, By, Bx = mv.shape[0], mv.shape[-2], mv.shape[-1]
    win = bs + 2 * border
    want = me._refine_level(pr, pv, nxt, mv, bs, border, ny, nx, cap)
    fns = {"": refine, **(variants or {})}
    err = max(_max_err(f(pr, pv, nxt, mv, bs, ny, nx, cap, border), want)
              for f in fns.values())
    ms = {k: _graph_ms(lambda f=f: f(pr, pv, nxt, mv, bs, ny, nx, cap,
                                     border))
          for k, f in fns.items()}
    eager_ms = (_cuda_ms(lambda: refine(pr, pv, nxt, mv, bs, ny, nx, cap,
                                        border)) if eager else None)
    # windows of more than 2^28 pixels in all (the sub-pixel steps 2-3):
    # the plain version takes up to 0.3 s a call there, so it runs once
    big = P * By * Bx * win * win > 2**28
    plain = _cuda_ms(lambda: me._refine_level(pr, pv, nxt, mv, bs, border,
                                              ny, nx, cap),
                     reps=1 if big else 3, batch=1 if big else 2,
                     warmup=0 if big else 2)
    # the least work: 18 probes (9 per reference) of |a - b| summed over
    # the win^2 pixels of each window, one subtraction and one addition
    # of an absolute value per term, both exact on the fp32 lanes while
    # the int16 differences cannot wrap (fp32 add with an |x| operand);
    # the bytes: the three planes, mv and the refined mv, each once
    bound = _bound(_nbytes(pr, pv, nxt, mv, want),
                   P * By * Bx * 18 * win * win * 2, FP32_OPS_PER_S)
    row = {"label": label, "max_abs_err": err, "ms": ms.pop(""),
           "eager_ms": eager_ms, "plain_ms": plain, "bound": bound,
           "variants": ms}
    extra = "".join(f", {k} {v:.4f} ms" for k, v in ms.items())
    b2b = f", back to back {eager_ms:.4f} ms" if eager else ""
    print(f"  K1 {label} ({ny}x{nx}, {By}x{Bx} blocks of {bs}, border "
          f"{border}, {P * By * Bx} blocks in all): max_abs_err {err}, "
          f"kernel {row['ms']:.4f} ms ({bound[0] / row['ms']:.0%} of its "
          f"{bound[0]:.4f} ms {bound[1]} bound){b2b}{extra}, plain "
          f"{plain:.4f} ms", flush=True)
    return row


def k1_calls(dev, refine, variants=None, seed=0):
    """K1 at each of its 14 calls in one flagship GOP: every pyramid depth
    of every temporal level, at the shapes ``me.estimate_sequence`` gives
    it (random 0..255 planes, |mv| <= search range + 1, one past the
    pad), then once more at level 1, depth 0, over the full int16 range
    (the kernel's wrap-around path; not part of the GOP).

    ``refine(pred, prev, next, mv, bs, ny, nx, sr, border)`` returns the
    refined vectors; each call must equal ``me._refine_level`` exactly.
    ``variants`` ({label: refine}) are checked and timed beside it.
    Returns one dict per call: label, gop (a call of the GOP), max_abs_err,
    ms (device time, CUDA graph), eager_ms (back-to-back calls), plain_ms,
    bound (ms, by) and {label: ms} of the variants."""
    rng = np.random.default_rng(seed)
    H, W, bs = FLAGSHIP_H, FLAGSHIP_W, FLAGSHIP_BS
    calls = [(lvl, P, sr, d, 0, 256)
             for lvl, (P, sr) in enumerate(FLAGSHIP_LEVELS, 1)
             for d in range(max(int(round(np.log2(sr))) - 1, 0) + 1)]
    calls.append((1, 8, 4, 0, -2**15, 2**15))
    rows = []
    for lvl, P, sr, d, lo, hi in calls:
        ny, nx = _ceil_half(H, d), _ceil_half(W, d)
        By, Bx = _ceil_half(H // bs, d), _ceil_half(W // bs, d)
        planes = [torch.from_numpy(rng.integers(
            lo, hi, (P, ny, nx)).astype(np.int16)).to(dev) for _ in range(3)]
        mv = torch.from_numpy(rng.integers(
            -sr - 1, sr + 2, (P, 2, 2, By, Bx)).astype(np.int32)).to(dev)
        label = (f"L{lvl} P={P} sr={sr} depth {d}"
                 + (" full int16" if lo < 0 else ""))
        rows.append(dict(_k1_row(label, planes, mv, bs, 0, ny, nx, sr,
                                 refine, variants), gop=lo == 0))
    gop = [r for r in rows if r["gop"]]
    print(f"  K1 per flagship GOP ({len(gop)} calls): kernel "
          f"{sum(r['ms'] for r in gop):.4f} ms, back to back "
          f"{sum(r['eager_ms'] for r in gop):.4f} ms, bound "
          f"{sum(r['bound'][0] for r in gop):.4f} ms", flush=True)
    return rows


def k1_wide_calls(dev, refine, seed=1):
    """K1 where the window is not the flagship's whole-pixel 64: the
    sub-pixel calls of a flagship GOP at accuracies a = 1-3 (step s of
    accuracy a refines blocks of 64 << s on frames interpolated 2^s times
    at every level's pairs, against cap = search range << a), one block
    of 1024 (step 3 of a block size of 128), and borders 1-4 at level 1,
    depth 0.  Random planes (0..255) and vectors (|mv| <= cap + 1), made
    on the card from ``seed``.  Returns the rows, each with ``a`` (its
    accuracy, None off the GOP's sub-pixel calls)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)
    rows = []
    for s in (1, 2, 3):
        H, W, bs = FLAGSHIP_H << s, FLAGSHIP_W << s, FLAGSHIP_BS << s
        planes = [rand(0, 256, (8, H, W), torch.int16) for _ in range(3)]
        for a in range(s, 4):
            for lvl, (P, sr) in enumerate(FLAGSHIP_LEVELS, 1):
                cap = sr << a
                mv = rand(-cap - 1, cap + 2, (P, 2, 2, H // bs, W // bs),
                          torch.int32)
                rows.append(dict(_k1_row(
                    f"a={a} s={s} L{lvl} P={P} cap={cap}",
                    [p[:P] for p in planes], mv, bs, 0, H, W, cap, refine,
                    eager=False), a=a))
        if s == 3:
            # blocks of 1024: accuracy 3 at a block size of 128
            H1 = H - H % 1024
            mv = rand(-257, 258, (1, 2, 2, H1 // 1024, W // 1024),
                      torch.int32)
            rows.append(dict(_k1_row(
                "bs 1024 P=1 cap=256", [p[:1, :H1] for p in planes], mv,
                1024, 0, H1, W, 256, refine, eager=False), a=None))
        del planes
    for a in (1, 2, 3):
        sub = [r for r in rows if r["a"] == a]
        print(f"  K1 sub-pixel calls of a flagship GOP at accuracy {a} "
              f"({len(sub)} calls): kernel {sum(r['ms'] for r in sub):.4f} "
              f"ms, bound {sum(r['bound'][0] for r in sub):.4f} ms",
              flush=True)
    H, W, bs = FLAGSHIP_H, FLAGSHIP_W, FLAGSHIP_BS
    for border in (1, 2, 3, 4):
        planes = [rand(0, 256, (8, H, W), torch.int16) for _ in range(3)]
        mv = rand(-5, 6, (8, 2, 2, H // bs, W // bs), torch.int32)
        rows.append(dict(_k1_row(f"L1 P=8 sr=4 depth 0 border {border}",
                                 planes, mv, bs, border, H, W, 4, refine),
                         a=None))
    return rows


def phase_kernel_parity(dev):
    from qsvc_tpu_torch.ops import cuda_me
    rng = np.random.default_rng(0)
    H, W, bs = FLAGSHIP_H, FLAGSHIP_W, FLAGSHIP_BS
    results = {}

    def rand_planes(shape, lo=0, hi=256, dtype=np.int16):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)
                                ).to(dev)

    def refine(pr, pv, nxt, mv, bs, ny, nx, sr, border, split=None):
        return cuda_me.refine(pr, pv, nxt, mv, bs, border, ny, nx, sr,
                              split)
    # beside the wrapper's choice of cluster size: one CTA per block
    k1 = k1_calls(dev, refine, {"one CTA per block": lambda *a: refine(
        *a, split=1)})
    k1 += k1_wide_calls(dev, refine)
    results["me_refine"] = (max(r["max_abs_err"] for r in k1), k1[0]["ms"],
                            k1[0]["plain_ms"], k1[0]["bound"])

    # K2, K3 and K4 at 8 pairs of 3 x 1088 x 1920: random |mv| <= 33,
    # then each flagship level's own call with its ME and random vectors
    P, C = 8, 3
    By, Bx = H // bs, W // bs
    prev, nxt = rand_planes((P, C, H, W)), rand_planes((P, C, H, W))
    contrib = rand_planes((P, C, H, W), -32, 32)
    mv = rand_planes((P, 2, 2, By, Bx), -33, 34, np.int32)
    mc = _mc_parity("P=8 sr=32 random", prev, nxt, contrib, mv, bs, 32)
    results.update(mc)
    for (P, sr), mv_me in zip(FLAGSHIP_LEVELS, _flagship_vectors(dev)):
        mv_rand = rand_planes((P, 2, 2, By, Bx), -sr - 1, sr + 2, np.int32)
        for kind, mv in (("ME", mv_me), ("random", mv_rand)):
            lv = _mc_parity(f"level P={P} sr={sr} {kind}", prev[:P],
                            nxt[:P], contrib[:P], mv, bs, sr)
            for name, row in lv.items():
                results[name] = (max(results[name][0], row[0]),) + \
                    results[name][1:]
    del prev, nxt, contrib
    for lv in _scaling_level_calls(dev, rand_planes):
        for name, row in lv.items():
            results[name] = (max(results[name][0], row[0]),) + \
                results[name][1:]

    err = _k2_subpixel_calls(dev)
    results["mc_predict"] = (max(results["mc_predict"][0], err),) + \
        results["mc_predict"][1:]
    for name, err in _ss_decode_calls(dev).items():
        results[name] = (max(results[name][0], err),) + results[name][1:]

    bad = {k: v[0] for k, v in results.items() if v[0] != 0}
    if bad:
        raise SystemExit(f"phase 2 kernel parity FAILED: {bad}")
    print("phase 2 kernel parity: ok (K1, K2, K3, K4 exact vs plain "
          "versions)", flush=True)
    return results


def _k2_subpixel_calls(dev, seed=2):
    """K2 as sub-pixel prediction calls it at accuracy a = 1-3: blocks of
    64 << a on level 1's 8 pairs of 4:4:4 references interpolated 2^a
    times, edge pad 4 * (4 << a), random |mv| <= (4 << a) + 1.  At a = 3
    (8704 x 15360, 6.4 GB per stack) the plain version runs on the first
    2 pairs, for the card's memory.  Returns the largest max_abs_err."""
    from qsvc_tpu_torch.mctf import predict
    from qsvc_tpu_torch.ops import cuda_mc
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    for a in (1, 2, 3):
        H, W, bs, sr = (FLAGSHIP_H << a, FLAGSHIP_W << a, FLAGSHIP_BS << a,
                        4 << a)
        prev, nxt = (torch.randint(0, 256, (8, 3, H, W), generator=gen,
                                   device=dev, dtype=torch.int16)
                     for _ in range(2))
        mv = torch.randint(-sr - 1, sr + 2, (8, 2, 2, H // bs, W // bs),
                           generator=gen, device=dev, dtype=torch.int32)
        got = cuda_mc.predict(prev, nxt, mv, bs, 4 * sr)
        n = 2 if a == 3 else 8
        err = _max_err(got[:n], predict.predict_frames_plain(
            prev[:n], nxt[:n], mv[:n], bs, 4 * sr))
        worst = max(worst, err)
        ms = _cuda_ms(lambda: cuda_mc.predict(prev, nxt, mv, bs, 4 * sr),
                      reps=3, batch=5)
        plain = _cuda_ms(lambda: predict.predict_frames_plain(
            prev[:n], nxt[:n], mv[:n], bs, 4 * sr), reps=1, batch=1,
            warmup=0)
        bound = _bound(_nbytes(prev, nxt, mv, got), 4 * got.numel())
        print(f"  K2 a={a} P=8 ({H}x{W}, blocks of {bs}, pad {4 * sr}): "
              f"max_abs_err {err} (plain version on {n} pairs), kernel "
              f"{ms:.4f} ms ({bound[0] / ms:.0%} of its {bound[0]:.4f} ms "
              f"{bound[1]} bound), plain {plain:.4f} ms on {n} pairs",
              flush=True)
        del prev, nxt, got
    return worst


def _ss_decode_calls(dev, seed=3):
    """K2 and K3 where the decode of a flagship stream reduced by SS at
    d = 1-4 calls them: frames of 1088x1920 >> d in blocks of 64 >> d,
    at each temporal level's (pairs, search range) of the reduced
    configuration ((8, 4, 2, 1) pairs, search 4 >> d doubling per level),
    random planes and |mv| <= search range + 1; each exact against its
    plain version, timed beside its byte bound.  Returns the largest
    max_abs_err by kernel."""
    from qsvc_tpu_torch.mctf import predict, update
    from qsvc_tpu_torch.ops import cuda_mc
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {"mc_predict": 0.0, "mc_update2": 0.0}
    for d in (1, 2, 3, 4):
        H, W, bs = FLAGSHIP_H >> d, FLAGSHIP_W >> d, FLAGSHIP_BS >> d
        prev, nxt = (torch.randint(0, 256, (8, 3, H, W), generator=gen,
                                   device=dev, dtype=torch.int16)
                     for _ in range(2))
        contrib = torch.randint(-32, 32, (8, 3, H, W), generator=gen,
                                device=dev, dtype=torch.int16)
        rows = []
        for lvl, (P, _) in enumerate(FLAGSHIP_LEVELS):
            sr = max(4 >> d, 1) << lvl
            mv = torch.randint(-sr - 1, sr + 2, (P, 2, 2, H // bs, W // bs),
                               generator=gen, device=dev, dtype=torch.int32)
            args = (prev[:P], nxt[:P], mv, bs, 4 * sr)
            k2 = cuda_mc.predict(*args)
            worst["mc_predict"] = max(worst["mc_predict"], _max_err(
                k2, predict.predict_frames_plain(*args)))
            k3 = cuda_mc.update2(contrib[:P], mv, bs, sr)
            want = torch.stack([update._update_sums(
                contrib[:P], mv[:, i, 0], mv[:, i, 1], bs, sr)
                for i in range(2)], dim=1)
            worst["mc_update2"] = max(worst["mc_update2"],
                                      _max_err(k3, want))
            k2_fn = functools.partial(cuda_mc.predict, *args)
            k3_fn = functools.partial(cuda_mc.update2, contrib[:P], mv, bs, sr)
            b2 = _bound(_nbytes(prev[:P], nxt[:P], mv, k2), 4 * k2.numel())
            b3 = _bound(_nbytes(contrib[:P], mv, k3), k3.numel())
            cells = []
            for name, fn, b in (("K2", k2_fn, b2), ("K3", k3_fn, b3)):
                dev_ms = _graph_ms(fn)
                cells.append(f"{name} {dev_ms:.4f} ms ({b[0] / dev_ms:.0%} "
                             f"of {b[0]:.4f} {b[1]}; back to back "
                             f"{_cuda_ms(fn):.4f})")
            rows.append(f"P={P} sr={sr}: {', '.join(cells)}")
        print(f"  SS d={d} decode calls ({H}x{W}, blocks of {bs}; device "
              f"ms of CUDA-graph replays, bounds in ms): {'; '.join(rows)}",
              flush=True)
    print(f"  SS decode calls max_abs_err: {worst}", flush=True)
    return worst


def _flagship_vectors(dev):
    """The vectors each temporal level of the flagship hands K2 and K3:
    one MCTF analysis, on the card, of phase 4's first GOP."""
    from qsvc_tpu_torch.io import synthetic_video
    from qsvc_tpu_torch.mctf import transform
    cfg = _flagship_cfg()
    gop = cfg.replace(GOPs=1)
    vid = synthetic_video(cfg.pictures, cfg.pixels_in_y, cfg.pixels_in_x,
                          seed=0)
    planes = [torch.from_numpy(p[:gop.pictures]).to(dev)
              for p in vid.planes()]
    levels = transform.analyze(*planes, gop).levels
    for lp, lev, (P, sr) in zip(gop.level_schedule(), levels,
                                FLAGSHIP_LEVELS):
        if (lev.mv.shape[0], lp.search_range) != (P, sr):
            raise SystemExit(f"phase 2: level {lp.temporal_subband} has "
                             f"{lev.mv.shape[0]} pairs at search range "
                             f"{lp.search_range}, not {(P, sr)}")
        print(f"  flagship level {lp.temporal_subband}: {P} pairs, "
              f"{int(lev.is_B.sum())} B, max |mv| "
              f"{int(lev.mv.abs().max())} at search range {sr}",
              flush=True)
    return [lev.mv.contiguous() for lev in levels]


def _scaling_level_calls(dev, rand_planes):
    """K2, K3 and K4 (each direction) at the calls of phase 8d's n = 1
    scaling point at its default configuration (512x512, block 32, TRLs
    3): each temporal level's (pairs, search range), with the vectors of
    that rank's MCTF analysis (same video, same GOP) and with random ones
    up to search range + 1.  Returns _mc_parity's rows, one per call."""
    from qsvc_tpu_torch.io import synthetic_video
    from qsvc_tpu_torch.mctf import transform
    from qsvc_tpu_torch.parallel import distributed as pdist
    cfg = pdist.SCALING_CONFIG.replace(GOPs=1)
    H, W = cfg.pixels_in_y, cfg.pixels_in_x
    vid = synthetic_video(cfg.pictures, H, W, seed=0)
    levels = transform.analyze(
        *(torch.from_numpy(p).to(dev) for p in vid.planes()), cfg).levels
    rows = []
    for lp, lev in zip(cfg.level_schedule(), levels):
        P, sr, bs = lev.mv.shape[0], lp.search_range, lp.block_size
        prev, nxt = rand_planes((P, 3, H, W)), rand_planes((P, 3, H, W))
        contrib = rand_planes((P, 3, H, W), -32, 32)
        mv_rand = rand_planes((P, 2, 2, H // bs, W // bs), -sr - 1, sr + 2,
                              np.int32)
        for kind, mv in (("ME", lev.mv.contiguous()), ("random", mv_rand)):
            rows.append(_mc_parity(
                f"scaling {H}x{W} block {bs} level P={P} sr={sr} {kind}",
                prev, nxt, contrib, mv, bs, sr))
    return rows


def _mc_parity(label, prev, nxt, contrib, mv, bs, sr):
    """K2, K3 and K4 (each direction) on one set of vectors, each exact
    against its plain version, with kernel, plain and bound times.
    Returns {name: (max_abs_err, ms, plain_ms, (bound_ms, bound_by))}."""
    from qsvc_tpu_torch.mctf import predict, update
    from qsvc_tpu_torch.ops import cuda_mc
    border = 4 * sr
    k2 = cuda_mc.predict(prev, nxt, mv, bs, border)
    plain = functools.partial(predict.predict_frames_plain, prev, nxt, mv,
                              bs, border)
    rows = {"mc_predict": (
        _max_err(k2, plain()),
        _cuda_ms(lambda: cuda_mc.predict(prev, nxt, mv, bs, border)),
        _cuda_ms(plain, reps=3, batch=2),
        # add, halve, clip: a few operations per output
        _bound(_nbytes(prev, nxt, mv, k2), 4 * k2.numel()))}

    def plain_update():
        return torch.stack([update._update_sums(contrib, mv[:, d, 0],
                                                mv[:, d, 1], bs, sr)
                            for d in range(2)], dim=1)
    want = plain_update()
    k3 = cuda_mc.update2(contrib, mv, bs, sr)
    # each source pixel feeds at most one destination per direction, so
    # the adds number at most one per output
    rows["mc_update2"] = (
        _max_err(k3, want),
        _cuda_ms(lambda: cuda_mc.update2(contrib, mv, bs, sr)),
        _cuda_ms(plain_update, reps=3, batch=2),
        _bound(_nbytes(contrib, mv, k3), k3.numel()))

    # K4, one direction as the sharded MCTF calls it: both directions
    # equal the plain version (and so K3's halves); timed on direction 0
    halves = [(mv[:, d, 0].contiguous(), mv[:, d, 1].contiguous())
              for d in range(2)]
    k4 = [cuda_mc.update1(contrib, my, mx, bs, sr) for my, mx in halves]
    my, mx = halves[0]
    rows["mc_update1"] = (
        max(_max_err(k4[d], want[:, d]) for d in range(2)),
        _cuda_ms(lambda: cuda_mc.update1(contrib, my, mx, bs, sr)),
        _cuda_ms(lambda: update._update_sums(contrib, my, mx, bs, sr),
                 reps=3, batch=2),
        _bound(_nbytes(contrib, my, mx, k4[0]), k4[0].numel()))
    print(f"  {label}: " + "; ".join(
        f"{_SHORT[name]} max_abs_err {err}, kernel {ms:.4f} ms "
        f"({bound[0] / ms:.0%} of its {bound[0]:.4f} ms {bound[1]} bound), "
        f"plain {pms:.4f} ms"
        for name, (err, ms, pms, bound) in rows.items()), flush=True)
    return rows



def phase_correctness(dev):
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec.codestream import VideoStream
    from qsvc_tpu_torch.config import CodecConfig
    from qsvc_tpu_torch.io import synthetic_video
    from qsvc_tpu_torch.mctf import transform

    # the kernels in context: MCTF analysis and synthesis on the card ==
    # the plain CPU run, whole-pixel and with sub-pixel ME/MC, OLA and a
    # border
    base = CodecConfig(pixels_in_x=256, pixels_in_y=128, TRLs=3, GOPs=1,
                       block_size=32, search_range=8, update_factor=0.25)
    vid = synthetic_video(base.pictures, 128, 256, seed=1, kind="translate")
    planes = [torch.from_numpy(p) for p in vid.planes()]

    for name, kw in MCTF_CASES.items():
        cfg = base.replace(**kw)
        on_card = transform.analyze(*(p.to(dev) for p in planes), cfg)
        on_cpu = transform.analyze(*planes, cfg)
        want = _flat_stream(on_cpu.to_numpy())
        if not all(np.array_equal(a, b) for a, b in
                   zip(_flat_stream(on_card.to_numpy()), want)):
            raise SystemExit(f"phase 3: MCTF analysis ({name}) on the card "
                             f"differs from the CPU")
        rec_card = transform.synthesize(on_card, cfg)
        rec_cpu = transform.synthesize(on_cpu, cfg)
        if not all(np.array_equal(a.cpu().numpy(), b.numpy())
                   for a, b in zip(rec_card, rec_cpu)):
            raise SystemExit(f"phase 3: MCTF synthesis ({name}) on the card "
                             f"differs from the CPU")
        # the captured programs (CUDA graphs) against the same CPU runs
        jit = transform.analyze_jit(*(p.to(dev) for p in planes), cfg)
        if not all(np.array_equal(a, b) for a, b in
                   zip(_flat_stream(jit.to_numpy()), want)):
            raise SystemExit(f"phase 3: analyze_jit ({name}) on the card "
                             f"differs from the CPU")
        if not all(np.array_equal(a.cpu().numpy(), b.numpy()) for a, b in
                   zip(transform.synthesize_jit(jit, cfg), rec_cpu)):
            raise SystemExit(f"phase 3: synthesize_jit ({name}) on the card "
                             f"differs from the CPU")

    # 1080p lossless round trip through the container bytes
    cfg = CodecConfig(pixels_in_x=1920, pixels_in_y=1088, TRLs=3, GOPs=1,
                      update_factor=0.0, quantization_texture=0)
    vid = synthetic_video(cfg.pictures, 1088, 1920, seed=3)
    t0 = time.time()
    data = api.compress(vid, cfg, device=dev).to_bytes()
    rec = api.expand(VideoStream.from_bytes(data), device=dev)
    dt = time.time() - t0
    for a, b, name in zip(rec.planes(), vid.planes(), "yuv"):
        if not np.array_equal(a, b):
            raise SystemExit(f"phase 3: lossless round trip differs ({name})")
    print(f"phase 3 correctness: ok (MCTF analysis and synthesis, eager "
          f"and as captured programs, card == CPU at 256x128: "
          f"{', '.join(MCTF_CASES)}; 1080p "
          f"TRLs=3 lossless round trip bit-exact, {len(data)} bytes, "
          f"{dt:.3f} s)", flush=True)


def phase_flagship(dev):
    return _staged_run(dev, _flagship_cfg(), "phase 4 flagship 1920x1088 "
                       "GOP16", "phase 4")


def _staged_run(dev, cfg, title, phase):
    """Encode (warm-up + timed) and decode (warm-up + timed) of
    ``cfg.GOPs`` GOPs of the flagship's video staged on the card, 9/7 at
    its slope; prints fps, bpp, PSNR, the launches (of the whole run, and
    of the timed encode and decode) and the peak device memory, fails if
    K1-K3 never launched or PSNR-Y < 25 dB; returns the launch counts of
    the run (set to 0 just before it) and its (bpp, PSNR-Y)."""
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec.codestream import VideoStream
    from qsvc_tpu_torch.io import Video, synthetic_video, video_psnr
    from qsvc_tpu_torch.ops import cuda_lib

    gops = cfg.GOPs
    vid = synthetic_video(cfg.pictures, 1088, 1920, seed=0)
    S = cfg.gop_size
    gop_cfg = cfg.replace(GOPs=1)
    staged = [Video(*(torch.from_numpy(p[g * S:(g + 1) * S + 1]).to(dev)
                      for p in vid.planes())) for g in range(gops)]
    torch.cuda.synchronize()

    def since(before):
        return {k: n - before.get(k, 0) for k, n in cuda_lib.launches.items()
                if n > before.get(k, 0)}
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.time()
    api.compress_chunks(staged, gop_cfg, reversible=False, device=dev)
    warm_s = time.time() - t0
    torch.cuda.synchronize()
    before = dict(cuda_lib.launches)
    t0 = time.time()
    streams = api.compress_chunks(staged, gop_cfg, reversible=False,
                                  device=dev)
    enc_s = time.time() - t0
    per_encode = since(before)
    blobs = [s.to_bytes() for s in streams]
    parsed = [VideoStream.from_bytes(b) for b in blobs]
    for s in parsed:                        # decode warm-up
        api.expand(s, to_host=False, device=dev)
    before = dict(cuda_lib.launches)
    t0 = time.time()
    recs = [api.expand(s, to_host=False, device=dev) for s in parsed]
    dec_s = time.time() - t0
    per_decode = since(before)
    counts = dict(cuda_lib.launches)
    peak = (torch.cuda.max_memory_allocated() / 2**30,
            torch.cuda.max_memory_reserved() / 2**30)

    def join(plane):
        parts = [getattr(r, plane).cpu().numpy() for r in recs]
        return np.concatenate([p[:-1] for p in parts] + [parts[-1][-1:]])
    rec = Video(join("y"), join("u"), join("v"))
    if rec.y.shape != vid.y.shape or rec.u.shape != vid.u.shape:
        raise SystemExit(f"{phase}: decoded shape {rec.y.shape}")
    py, pu, pv = video_psnr(vid, rec)
    bpp = sum(len(b) for b in blobs) * 8 / (vid.y.size * 3 // 2)
    missing = [k for k in SEQUENTIAL_KERNELS if counts.get(k, 0) == 0]
    print(f"{title} x{gops}: encode "
          f"{vid.frames / enc_s:.3f} fps ({enc_s:.3f} s, warm-up "
          f"{warm_s:.3f} s), decode {vid.frames / dec_s:.3f} fps "
          f"({dec_s:.3f} s), {bpp:.5f} bpp, PSNR-Y/U/V {py:.3f}/{pu:.3f}/"
          f"{pv:.3f} dB, launches {counts} (per timed {gops}-GOP encode "
          f"{per_encode}, per timed decode {per_decode}), peak device "
          f"memory {peak[0]:.3f} GiB allocated, {peak[1]:.3f} GiB "
          f"reserved", flush=True)
    if missing:
        raise SystemExit(f"{phase}: kernels never launched: {missing}")
    if not py >= 25.0:
        raise SystemExit(f"{phase}: PSNR-Y {py:.3f} dB < 25 dB")
    return counts, (bpp, py)


def phase_subpixel(dev):
    """6: the flagship with sub-pixel motion, a = 2 (phase 4's run), then
    one GOP at a = 3 with OLA (block_overlaping 8) and border_size 2,
    lossless, round-tripped through its container bytes."""
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec.codestream import VideoStream
    from qsvc_tpu_torch.io import synthetic_video
    from qsvc_tpu_torch.ops import cuda_lib

    t_start = time.time()
    _staged_run(dev, _flagship_cfg(subpixel_accuracy=2),
                "phase 6 sub-pixel flagship a=2 1920x1088 GOP16", "phase 6")
    torch.cuda.empty_cache()
    cfg = _flagship_cfg(GOPs=1, subpixel_accuracy=3, block_overlaping=8,
                        border_size=2, update_factor=0.0,
                        quantization_texture=0)
    vid = synthetic_video(cfg.pictures, 1088, 1920, seed=0)
    cuda_lib.reset_launches()
    data, enc_s = _timed(lambda: api.compress(vid, cfg, reversible=True,
                                              device=dev).to_bytes())
    counts = dict(cuda_lib.launches)
    rec, dec_s = _timed(lambda: api.expand(VideoStream.from_bytes(data),
                                           device=dev))
    for a, b, name in zip(rec.planes(), vid.planes(), "yuv"):
        if not np.array_equal(a, b):
            raise SystemExit(f"phase 6: the a=3 OLA lossless round trip "
                             f"differs ({name})")
    if counts.get("me_refine", 0) == 0:
        raise SystemExit(f"phase 6: the a=3 encode never launched K1: "
                         f"{counts}")
    print(f"phase 6 a=3 OLA d=8 border 2 lossless GOP of 1920x1088: ok, "
          f"bit-exact through {len(data)} bytes; encode {enc_s:.3f} s, "
          f"decode {dec_s:.3f} s, launches per encode {counts}; phase "
          f"{time.time() - t_start:.3f} s", flush=True)


def _flagship_cfg(**kw):
    from qsvc_tpu_torch.config import CodecConfig
    args = dict(pixels_in_x=1920, pixels_in_y=1088, TRLs=5, GOPs=4, SRLs=5,
                search_range=4, update_factor=0.25,
                quantization_texture=45000)
    args.update(kw)
    return CodecConfig(**args)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def phase_sharded(dev):
    """5a: the sharded flagship on one rank against the sequential one."""
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.io import synthetic_video
    from qsvc_tpu_torch.ops import cuda_lib
    from qsvc_tpu_torch.parallel import distributed as pdist

    cfg = _flagship_cfg()
    vid = synthetic_video(cfg.pictures, cfg.pixels_in_y, cfg.pixels_in_x,
                          seed=0)
    mesh = pdist.make_gop_mesh(dev)

    def sharded():
        return pdist.compress_distributed(vid, cfg, mesh,
                                          reversible=False).to_bytes()

    def sequential():
        return api.compress(vid, cfg, reversible=False,
                            device=dev).to_bytes()
    cuda_lib.reset_launches()
    got, first_s = _timed(sharded)
    counts = dict(cuda_lib.launches)
    want = sequential()
    if got != want:
        raise SystemExit(f"phase 5a: compress_distributed differs from "
                         f"api.compress ({len(got)} vs {len(want)} bytes)")
    if counts.get("mc_update1", 0) == 0 or counts.get("mc_update2", 0):
        raise SystemExit(f"phase 5a: the sharded encode must launch K4 and "
                         f"not K3: {counts}")
    gops = pdist.encode_gops_distributed(vid, cfg, mesh, reversible=False)
    if gops != [s.to_bytes() for s in api.compress_gops(
            vid, cfg, reversible=False, device=dev)]:
        raise SystemExit("phase 5a: encode_gops_distributed differs from "
                         "api.compress_gops")
    _, shard_s = _timed(sharded)
    _, seq_s = _timed(sequential)
    print(f"phase 5a sharded flagship, 1 rank: ok (compress_distributed == "
          f"api.compress, {len(got)} bytes; encode_gops_distributed == "
          f"api.compress_gops, {len(gops)} streams; warm encode of "
          f"{vid.frames} frames: sharded {shard_s:.3f} s, sequential "
          f"{seq_s:.3f} s, first sharded call {first_s:.3f} s; launches "
          f"{counts})", flush=True)
    return counts


def _halo_video(cfg):
    from qsvc_tpu_torch.io import synthetic_video
    return synthetic_video(cfg.pictures, cfg.pixels_in_y, cfg.pixels_in_x,
                           seed=5)


def _halo_rank(rank, world, store, device, cfg):
    """One rank of phase 5b (a process of ``pdist.run_ranks``)."""
    import datetime
    import torch.distributed as dist
    from qsvc_tpu_torch.ops import cuda_lib
    from qsvc_tpu_torch.parallel import distributed as pdist
    from qsvc_tpu_torch.parallel import transform as ptransform

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    # gloo, not nccl: both ranks share one card
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = pdist.make_gop_mesh(dev)
        vid = _halo_video(cfg)
        cuda_lib.reset_launches()
        data = pdist.compress_distributed(vid, cfg, mesh,
                                          reversible=True).to_bytes()
        launches = cuda_lib.launches["mc_update1"]
        st = ptransform.analyze_sharded(
            *pdist.shard_video_gops(vid, cfg, mesh), cfg, mesh)
        rec = ptransform.synthesize_sharded(st, cfg, mesh)
        out = dict(data=data, launches=launches,
                   **{c: p.cpu().numpy() for c, p in zip("yuv", rec)})
        pdist.end_group()
        return out
    finally:
        if dist.is_initialized():       # a failed rank: no barrier
            dist.destroy_process_group()


def phase_halo(dev):
    """5b: two gloo ranks on this card against the sequential encode."""
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.mctf import transform
    from qsvc_tpu_torch.parallel import distributed as pdist
    from qsvc_tpu_torch.parallel import mesh as pmesh

    cfg = _flagship_cfg(GOPs=2, quantization_texture=0)
    vid = _halo_video(cfg)
    world = 2
    card = f"cuda:{torch.cuda.current_device()}"
    torch.cuda.empty_cache()
    t0 = time.time()
    try:
        ranks = pdist.run_ranks(_halo_rank, world, card, cfg)
    except RuntimeError as e:           # a rank failed: the phase fails
        raise SystemExit(f"phase 5b: a rank failed: {e}")
    ranks_s = time.time() - t0
    want = api.compress(vid, cfg, reversible=True, device=dev).to_bytes()
    for r, res in enumerate(ranks):
        if res["data"] != want:
            raise SystemExit(f"phase 5b: rank {r}'s compress_distributed "
                             f"differs from the sequential api.compress")
        if int(res["launches"]) == 0:
            raise SystemExit(f"phase 5b: rank {r} never launched K4")
    seq = transform.synthesize(transform.analyze(
        *(torch.from_numpy(p).to(dev) for p in vid.planes()), cfg), cfg)
    for c, plane in zip("yuv", seq):
        got = pmesh.unshard_gops(np.stack([res[c] for res in ranks]))
        if not np.array_equal(got, plane.cpu().numpy()):
            raise SystemExit(f"phase 5b: synthesize_sharded differs from "
                             f"transform.synthesize ({c})")
    print(f"phase 5b halo on the card, {world} gloo ranks: ok (both ranks' "
          f"lossless compress_distributed == api.compress, {len(want)} "
          f"bytes; synthesize_sharded == transform.synthesize; K4 launches "
          f"per rank {[int(res['launches']) for res in ranks]}; ranks took "
          f"{ranks_s:.3f} s with start-up)", flush=True)


def phase_nccl():
    """5c: where several cards are visible, ``tools/nccl_halo.py``'s
    check over nccl, one rank per card (its lossy, sub-pixel and lossless
    flagship runs against the sequential ones on this card)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print("phase 5c nccl across cards: one card visible, not run",
              flush=True)
        return
    from tools.nccl_halo import check
    try:
        res = check(cards)
    except RuntimeError as e:           # a rank failed: the phase fails
        raise SystemExit(f"phase 5c: a rank failed: {e}")
    if not res["ok"]:
        raise SystemExit(f"phase 5c: {res['mismatches']}")
    rows = [f"{name} {run['distributed_fps']:.3f} fps distributed / "
            f"{run['sequential_fps']:.3f} sequential, halo s per rank "
            f"{[round(x, 4) for x in run['rank_halo_seconds']]}"
            for name, run in res["runs"].items()]
    print(f"phase 5c nccl across {cards} cards: ok (every rank's streams "
          f"== the sequential ones, lossless synthesis and closed GOPs "
          f"too; {'; '.join(rows)})", flush=True)


def _cli(argv):
    """``qsvc_tpu_torch.cli.main(argv)`` in this process: (stdout, stderr,
    wall seconds); a non-zero return fails phase 7."""
    import contextlib
    import io
    from qsvc_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    dt = time.time() - t0
    if rc != 0:
        raise SystemExit(f"phase 7: cli {' '.join(argv)} returned {rc}:\n"
                         f"{out.getvalue()}{err.getvalue()}")
    return out.getvalue(), err.getvalue(), dt


def _surface_cli(dev, tmp):
    """7a: the CLI on 33 frames (2 GOPs) of the flagship's video, through
    a .yuv file: lossless with a resume store (run twice: the second run
    takes both GOPs from the store) and expanded byte for byte; lossy at
    45000 with info, transcode (QS, TS, SS) and rd.  Returns the lossy
    file's first GOP, and the launches of each compress."""
    from qsvc_tpu_torch.codec import codestream
    from qsvc_tpu_torch.io import synthetic_video, write_yuv
    from qsvc_tpu_torch.ops import cuda_lib

    n, H, W = 33, FLAGSHIP_H, FLAGSHIP_W
    vid = synthetic_video(n, H, W, seed=0)
    src = os.path.join(tmp, "in.yuv")
    write_yuv(src, vid)
    flags = ["--pixels_in_x", str(W), "--pixels_in_y", str(H), "--TRLs",
             "5", "--SRLs", "5", "--search_range", "4", "--pictures",
             str(n), "--device", str(dev)]
    path = {k: os.path.join(tmp, k) for k in (
        "ll.qsvc", "ll.yuv", "lossy.qsvc", "q.qsvc", "ts.qsvc", "ts.yuv",
        "ss.qsvc", "ss.yuv", "store")}

    def compress(out, extra):
        cuda_lib.reset_launches()
        _, err, dt = _cli(["compress", "--input", src, "--output", out]
                          + flags + extra)
        return err, dt, dict(cuda_lib.launches)

    ll = ["--lossless", "--update_factor", "0", "--resume", path["store"]]
    _, ll_s, ll_launch = compress(path["ll.qsvc"], ll)
    err, cached_s, _ = compress(path["ll.qsvc"], ll)
    if err.count("(cached)") != 2:
        raise SystemExit(f"phase 7: the resumed compress re-encoded: {err}")
    _, _, llx_s = _cli(["expand", "--input", path["ll.qsvc"], "--output",
                        path["ll.yuv"], "--device", str(dev)])
    with open(src, "rb") as a, open(path["ll.yuv"], "rb") as b:
        if a.read() != b.read():
            raise SystemExit("phase 7: the lossless CLI round trip differs")

    _, lossy_s, lossy_launch = compress(path["lossy.qsvc"], [])
    out, _, _ = _cli(["info", "--input", path["lossy.qsvc"]])
    if "--- GOP 0 ---" not in out or "--- GOP 1 ---" not in out:
        raise SystemExit(f"phase 7: info does not list both GOPs:\n{out}")
    sizes = {}
    for name, extra in (("q", ["--quantization", "46000"]),
                        ("ts", ["--discard_TRLs", "1"]),
                        ("ss", ["--discard_SRLs", "1"])):
        _cli(["transcode", "--input", path["lossy.qsvc"], "--output",
              path[f"{name}.qsvc"]] + extra)
        sizes[name] = os.path.getsize(path[f"{name}.qsvc"])
    if not sizes["q"] < os.path.getsize(path["lossy.qsvc"]):
        raise SystemExit("phase 7: transcode --quantization 46000 did not "
                         "shrink the stream")
    expand_s = {}
    for name, frames, h, w in (("ts", 17, H, W), ("ss", n, H // 2, W // 2)):
        _, _, expand_s[name] = _cli(
            ["expand", "--input", path[f"{name}.qsvc"], "--output",
             path[f"{name}.yuv"], "--device", str(dev)])
        if os.path.getsize(path[f"{name}.yuv"]) != frames * h * w * 3 // 2:
            raise SystemExit(f"phase 7: the {name} extraction does not "
                             f"expand to {frames} frames of {w}x{h}")
    out, _, rd_s = _cli(["rd", "--input", path["lossy.qsvc"], "--original",
                         src, "--quantizations", "45000,46000", "--device",
                         str(dev)])
    points = [ln for ln in out.splitlines() if ln and ln[0] != "#"]
    if len(points) != 2:
        raise SystemExit(f"phase 7: rd printed {len(points)} points:\n{out}")
    with open(path["lossy.qsvc"], "rb") as f:
        lossy = f.read()
    print(f"  7a CLI, {n} frames of {W}x{H} through .yuv files (file I/O "
          f"included): lossless compress {n / ll_s:.3f} fps ({ll_s:.3f} s, "
          f"launches {ll_launch}), resumed from the store {cached_s:.3f} s, "
          f"expand {n / llx_s:.3f} fps, byte for byte; lossy 45000 "
          f"compress {n / lossy_s:.3f} fps ({len(lossy)} bytes, launches "
          f"{lossy_launch}); transcode to {sizes} bytes; TS expand "
          f"{17 / expand_s['ts']:.3f} fps, SS expand {n / expand_s['ss']:.3f}"
          f" fps; rd of 2 points {rd_s:.3f} s: {points}", flush=True)
    return codestream.unpack_gop_streams(lossy)[0]


def _surface_extraction(dev, lossy_gop):
    """7b: one lossless 5/3 flagship GOP (update 1/4) reduced by SS at
    d = 1 and 4 (K2 and K3 at blocks of 32 and 4) and by TS at d = 1,
    each decoded on the card and on the CPU, which must be bit-identical;
    then FS rate control at a third of a lossy GOP's bytes."""
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec.codestream import VideoStream
    from qsvc_tpu_torch.io import synthetic_video
    from qsvc_tpu_torch.ops import cuda_lib
    from qsvc_tpu_torch.scal import extract

    cfg = _flagship_cfg(GOPs=1, quantization_texture=0)
    vid = synthetic_video(cfg.pictures, FLAGSHIP_H, FLAGSHIP_W, seed=0)
    vs = VideoStream.from_bytes(api.compress(vid, cfg, reversible=True,
                                             device=dev).to_bytes())
    rows = []
    for name, sub in (("SS d=1", extract.spatial_truncate(vs, 1)),
                      ("SS d=4", extract.spatial_truncate(vs, 4)),
                      ("TS d=1", extract.temporal_truncate(vs, 1))):
        cuda_lib.reset_launches()
        card, card_s = _timed(lambda: api.expand(sub, device=dev))
        counts = dict(cuda_lib.launches)
        t0 = time.time()
        cpu = api.expand(sub, device="cpu")
        cpu_s = time.time() - t0
        for a, b, c in zip(card.planes(), cpu.planes(), "yuv"):
            if not np.array_equal(a, b):
                raise SystemExit(f"phase 7: the {name} decode on the card "
                                 f"differs from the CPU ({c})")
        if not all(counts.get(k, 0) for k in ("mc_predict", "mc_update2")):
            raise SystemExit(f"phase 7: the {name} decode did not launch "
                             f"K2 and K3: {counts}")
        rows.append(f"{name}, {card.frames} frames of {card.width}x"
                    f"{card.height} in blocks of {sub.cfg.auto_block_size}"
                    f": card {card.frames / card_s:.3f} fps ({card_s:.3f} s,"
                    f" launches {counts}), CPU {cpu_s:.3f} s")
    lossy = VideoStream.from_bytes(lossy_gop)
    budget = len(lossy_gop) // 3
    t0 = time.time()
    fs = extract.select_for_rate(lossy, budget, "FS")
    fs_s = time.time() - t0
    got = sum(fs.texture_bytes().values()) + sum(fs.motion_bytes().values())
    if got > budget * 1.05:
        raise SystemExit(f"phase 7: FS kept {got} bytes of a {budget} "
                         f"budget")
    if api.expand(fs, device=dev).y.shape != (17, FLAGSHIP_H, FLAGSHIP_W):
        raise SystemExit("phase 7: the FS extraction decodes to another "
                         "shape")
    print(f"  7b reduced decodes of a lossless 5/3 GOP, card == CPU: "
          f"{'; '.join(rows)}; FS to {budget} of {len(lossy_gop)} bytes "
          f"({got} kept) in {fs_s:.3f} s on the host", flush=True)


def _surface_backends(dev):
    """7c: one flagship GOP through the cp, zlib (update 0: exact) and
    ltw (PSNR-Y >= 25 dB) backends and back through container bytes,
    with each encode's seconds, bytes and launches."""
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec import backends
    from qsvc_tpu_torch.codec.codestream import VideoStream
    from qsvc_tpu_torch.io import synthetic_video, video_psnr
    from qsvc_tpu_torch.ops import cuda_lib

    vid = synthetic_video(17, FLAGSHIP_H, FLAGSHIP_W, seed=0)
    total = collections.Counter()
    rows = []
    for name, kw in (("cp", dict(update_factor=0.0)),
                     ("zlib", dict(update_factor=0.0)), ("ltw", {})):
        cfg = _flagship_cfg(GOPs=1, texture_backend=name, **kw)
        cuda_lib.reset_launches()
        data, enc_s = _timed(lambda: api.compress(vid, cfg,
                                                  device=dev).to_bytes())
        counts = dict(cuda_lib.launches)
        total.update(counts)
        rec, dec_s = _timed(lambda: api.expand(VideoStream.from_bytes(data),
                                               device=dev))
        py = video_psnr(vid, rec)[0]
        if name == "ltw":
            if not py >= 25.0:
                raise SystemExit(f"phase 7: ltw PSNR-Y {py:.3f} dB < 25")
        elif not all(np.array_equal(a, b)
                     for a, b in zip(rec.planes(), vid.planes())):
            raise SystemExit(f"phase 7: the {name} round trip differs")
        rows.append(f"{name} encode {enc_s:.3f} s, {len(data)} bytes, "
                    f"decode {dec_s:.3f} s, PSNR-Y {py:.3f} dB, launches "
                    f"{counts}")
    missing = [k for k in SEQUENTIAL_KERNELS if total.get(k, 0) == 0]
    if missing:
        raise SystemExit(f"phase 7: the backend encodes never launched "
                         f"{missing}")
    print(f"  7c backends registered here: {list(backends.available())}; "
          f"one GOP of {FLAGSHIP_W}x{FLAGSHIP_H}: {'; '.join(rows)}",
          flush=True)


def phase_surface(dev):
    """7: the codec's user surface on the card: the CLI, reduced
    decodes and extraction, the texture backends."""
    t_start = time.time()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        lossy_gop = _surface_cli(dev, tmp)
    _surface_extraction(dev, lossy_gop)
    _surface_backends(dev)
    print(f"phase 7 the codec's user surface: ok; phase "
          f"{time.time() - t_start:.3f} s", flush=True)


def _rest_filter_banks(dev, vid):
    """8a: the Haar, 13/7 and S+P banks at 4 levels over the flagship's
    17 lumas (int32, minus 128) on the card: exact round trips, the card
    equal to the CPU on 2 frames, ms and device operations per call;
    then ``upsample2``/``downsample2`` with Haar on the 4:2:0 chroma
    stack and ``border.pad_edge`` of the luma stack, card == CPU."""
    from qsvc_tpu_torch.ops import border, dwt2d
    x = torch.from_numpy(vid.y.astype(np.int32) - 128).to(dev)
    x_cpu = x[:2].cpu()
    rows = []
    for filt in ("haar", "13/7", "sp"):
        a = dwt2d.analyze(x, 4, filt)
        s = dwt2d.synthesize(a, 4, filt)
        if not torch.equal(s, x):
            raise SystemExit(f"phase 8a: {filt} round trip differs")
        a_cpu = dwt2d.analyze(x_cpu, 4, filt)
        if not (torch.equal(a[:2].cpu(), a_cpu) and torch.equal(
                dwt2d.synthesize(a[:2], 4, filt).cpu(),
                dwt2d.synthesize(a_cpu, 4, filt))):
            raise SystemExit(f"phase 8a: {filt} on the card differs from "
                             f"the CPU")
        ms = [_cuda_ms(f, reps=3, batch=1, warmup=1) for f in (
            lambda: dwt2d.analyze(x, 4, filt),
            lambda: dwt2d.synthesize(a, 4, filt))]
        ops = [profile_run(f)[3] for f in (
            lambda: dwt2d.analyze(x, 4, filt),
            lambda: dwt2d.synthesize(a, 4, filt))]
        rows.append(f"{filt} analyze {ms[0]:.3f} ms ({ops[0]} device ops), "
                    f"synthesize {ms[1]:.3f} ms ({ops[1]})")
    c = torch.from_numpy(vid.u.astype(np.int32)).to(dev)
    for name, got, want in (
            ("upsample2", dwt2d.upsample2(c, "haar")[:2],
             dwt2d.upsample2(c[:2].cpu(), "haar")),
            ("downsample2", dwt2d.downsample2(c, "haar")[:2],
             dwt2d.downsample2(c[:2].cpu(), "haar")),
            ("pad_edge", border.pad_edge(x, 16)[:2],
             border.pad_edge(x_cpu, 16))):
        if not torch.equal(got.cpu(), want):
            raise SystemExit(f"phase 8a: {name} on the card differs from "
                             f"the CPU")
    print(f"  8a filter banks, 4 levels of {tuple(x.shape)} int32, exact "
          f"round trips, card == CPU on 2 frames: {'; '.join(rows)}; Haar "
          f"upsample2/downsample2 of {tuple(c.shape)} chroma and pad_edge "
          f"16 of the lumas card == CPU", flush=True)


def _rest_pair_steps(dev, vid):
    """8b: one flagship triple at level 1 (block 64, search 4):
    ``estimate_pair`` (K1) and ``decorrelate_pair``/``correlate_pair``
    (K2) on the card against the CPU, and the odd frame back exactly.
    Returns the launches of each step's run."""
    from qsvc_tpu_torch.mctf import me, predict
    from qsvc_tpu_torch.ops import cuda_lib
    y, u, v = (torch.from_numpy(p[:3].astype(np.int16)) for p in
               vid.planes())
    on_card = [p.to(dev) for p in (y, u, v)]
    bs, sr = FLAGSHIP_BS, 4

    def steps(yd, ud, vd):
        mv = me.estimate_pair(yd[1], yd[0], yd[2], bs, sr)
        refs = predict.refs_to_444_batch((yd[0::2], ud[0::2],
                                          vd[0::2]))
        res = predict.decorrelate_pair((yd[1], ud[1], vd[1]), refs[0],
                                       refs[1], mv, bs, sr)
        back = predict.correlate_pair(res[:3], refs[0], refs[1], res.mv_out,
                                      res.is_B, bs, sr)
        return mv, res, back
    cuda_lib.reset_launches()
    mv, res, back = steps(*on_card)
    counts = dict(cuda_lib.launches)
    mv_c, res_c, _ = steps(y, u, v)
    if not torch.equal(mv.cpu(), mv_c):
        raise SystemExit("phase 8b: estimate_pair on the card differs from "
                         "the CPU")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(res, res_c)):
        raise SystemExit("phase 8b: decorrelate_pair on the card differs "
                         "from the CPU")
    if not all(torch.equal(a.cpu(), b) for a, b in
               zip(back, (y[1], u[1], v[1]))):
        raise SystemExit("phase 8b: correlate_pair does not give back the "
                         "odd frame")
    if counts.get("me_refine", 0) == 0 or counts.get("mc_predict", 0) == 0:
        raise SystemExit(f"phase 8b: K1 and K2 must launch: {counts}")
    ms = _cuda_ms(lambda: steps(*on_card), reps=3, batch=1, warmup=1)
    print(f"  8b one-pair steps of a flagship triple (block {bs}, search "
          f"{sr}): estimate_pair, decorrelate_pair (B frame: "
          f"{bool(res.is_B)}) and correlate_pair card == CPU, odd frame "
          f"back exactly; launches {counts}; the three steps {ms:.3f} ms",
          flush=True)
    return counts


def _spec_coder_block(job):
    """One code-block of 8c (a process of a pool): the spec and the
    native coder's streams, and their decodes at every truncation.
    Returns (band, passes, spec s, native s, fault or None)."""
    from qsvc_tpu_torch.codec import fast, tier1
    band, c = job
    fast.build_seconds()            # load the library outside the timing
    t0 = time.perf_counter()
    py = tier1.encode_codeblock(c, band)
    t1 = time.perf_counter()
    cc = fast.encode_codeblock(c, band)
    t2 = time.perf_counter()
    fault = None
    if (cc.data, cc.msbs, cc.pass_ends) != (py.data, py.msbs, py.pass_ends):
        fault = "the native stream differs from the spec coder's"
    elif not np.allclose(cc.pass_dist, py.pass_dist, rtol=1e-9, atol=1e-6):
        fault = "the pass distortions differ"
    else:
        for n in range(py.num_passes + 1):
            if not np.array_equal(
                    fast.decode_codeblock(py.data, py.msbs, n, c.shape,
                                          band, py.pass_ends),
                    tier1.decode_codeblock(py.data, py.msbs, n, c.shape,
                                           band, py.pass_ends)):
                fault = f"the decodes at {n} passes differ"
                break
    return band, py.num_passes, t1 - t0, t2 - t1, fault


def _rest_spec_coder(dev, vid, seed=4):
    """8c: 64 seeded 32x32 code-blocks, 16 from each band type, of the
    flagship's quantized 9/7 lumas: the spec coder (``codec.tier1``) and
    the native one give the same bytes, msbs and pass ends, and decode
    alike at every truncation (the blocks spread over a pool of host
    processes: the spec coder is pure Python); ms per block of each."""
    import concurrent.futures
    import multiprocessing
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec import frame_codec, subbands
    cfg = _flagship_cfg()
    delta = api._operating_point(cfg, False, None, None)[0]
    q = frame_codec._dwt_quant(
        torch.from_numpy(vid.y[:4]).to(dev), cfg.SRLs - 1, False,
        torch.tensor(delta, dtype=torch.float32, device=dev)).cpu().numpy()
    rng = np.random.default_rng(seed)
    layout = subbands.band_layout(FLAGSHIP_H, FLAGSHIP_W, cfg.SRLs - 1)
    jobs = []
    for band in ("LL", "LH", "HL", "HH"):
        cand = [b for b in layout if b.band == band]
        for _ in range(16):
            b = cand[rng.integers(len(cand))]
            y0 = b.y0 + int(rng.integers(b.h - 31))
            x0 = b.x0 + int(rng.integers(b.w - 31))
            jobs.append((band, q[rng.integers(len(q)), y0:y0 + 32,
                                 x0:x0 + 32].astype(np.int64)))
    workers = min(8, os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        rows = list(ex.map(_spec_coder_block, jobs))
    faults = [(band, f) for band, _, _, _, f in rows if f]
    if faults:
        raise SystemExit(f"phase 8c: spec and native coder differ: "
                         f"{faults}")
    k = len(rows)
    print(f"  8c spec coder: {k} blocks of 32x32 "
          f"({sum(r[1] for r in rows)} passes) in {workers} host "
          f"processes, tier1 == native in bytes, msbs and pass ends, "
          f"decodes equal at every truncation; encode "
          f"{sum(r[2] for r in rows) / k * 1e3:.3f} ms per block (spec, "
          f"pure Python) against {sum(r[3] for r in rows) / k * 1e3:.4f} "
          f"(native)", flush=True)


def _rest_scaling(dev, vid):
    """8d: ``measure_scaling`` on this card at the JAX default
    configuration and at the flagship's (TRLs 5, 1 GOP), and across
    every card over nccl where there are several.  Phase 2 holds K4 at
    both configurations' calls against its plain version (the flagship
    levels, and ``_scaling_level_calls``).  Returns K4's launches
    ({"mc_update1": n})."""
    from qsvc_tpu_torch.parallel import distributed as pdist
    k4 = 0
    rows = []
    for name, cfg in (("512x512 TRLs 3", None),
                      ("flagship", _flagship_cfg(GOPs=1))):
        res = pdist.measure_scaling(1, reps=2, cfg=cfg, device=dev.type)
        n = res["launches"][1].get("mc_update1", 0)
        if n == 0:
            raise SystemExit(f"phase 8d: measure_scaling ({name}) never "
                             f"launched K4: {res['launches']}")
        k4 += n
        rows.append(f"{name} fps_1 {res['fps_1']:.3f} (K4 launches {n})")
    cards = torch.cuda.device_count()
    if cards >= 2:
        res = pdist.measure_scaling(cards, reps=2, device=dev.type)
        rows.append(f"nccl over {cards} cards: fps_n {res['fps_n']:.3f}, "
                    f"efficiency {res['efficiency']:.4f}")
    else:
        rows.append("one card: n = 1 only")
    print(f"  8d measure_scaling, one spawned rank per card: "
          f"{'; '.join(rows)}", flush=True)
    return {"mc_update1": k4}


def _rest_dense_encode(dev, vid):
    """8e: ``encode_frames_dispatch``/``fetch`` of the 17 flagship lumas
    equal ``_dwt_quant`` (int16 on the host), and a 9/7 step of 1e-4,
    whose indices overflow int16, takes the int32 path."""
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec import frame_codec
    cfg = _flagship_cfg()
    levels = cfg.SRLs - 1
    delta = api._operating_point(cfg, False, None, None)[0]
    planes = torch.from_numpy(vid.y).to(dev)
    rows = []
    for d, dtype in ((delta, np.int16), (1e-4, np.int32)):
        got, sec = _timed(lambda: frame_codec.encode_frames_fetch(
            frame_codec.encode_frames_dispatch(planes, levels, False, d,
                                               device=dev)))
        want = frame_codec._dwt_quant(
            planes, levels, False,
            torch.tensor(d, dtype=torch.float32, device=dev)).cpu().numpy()
        if got.dtype != dtype or not np.array_equal(got, want):
            raise SystemExit(f"phase 8e: dispatch/fetch at delta {d} gave "
                             f"{got.dtype}, not _dwt_quant's {dtype.__name__}")
        rows.append(f"delta {d:g}: {got.dtype} in {sec:.3f} s")
    print(f"  8e dense two-stage encode of {tuple(planes.shape)} == "
          f"_dwt_quant: {'; '.join(rows)}", flush=True)


def phase_rest(dev):
    """8: the rest of the JAX package's surface, at the flagship's width.
    Returns the launches of its kernel paths (8b, 8d), each read just
    after its own run."""
    from qsvc_tpu_torch.io import synthetic_video
    t_start = time.time()
    torch.cuda.empty_cache()
    vid = synthetic_video(17, FLAGSHIP_H, FLAGSHIP_W, seed=0)
    secs = {}
    counts = collections.Counter()
    for name, fn in (("8a", _rest_filter_banks), ("8b", _rest_pair_steps),
                     ("8c", _rest_spec_coder), ("8d", _rest_scaling),
                     ("8e", _rest_dense_encode)):
        t0 = time.time()
        counts.update(fn(dev, vid) or {})
        secs[name] = round(time.time() - t0, 3)
    print(f"phase 8 the rest of the JAX surface: ok; phase "
          f"{time.time() - t_start:.3f} s ({secs} s)", flush=True)
    return counts


@contextlib.contextmanager
def _eager_programs():
    """The port's API with its captured programs swapped for their eager
    functions, for phase 9's comparisons and ``tools/graphs_ab.py``'s
    parent-free baseline; restored on exit.  The port has no such switch
    itself."""
    from qsvc_tpu_torch.codec import frame_codec
    from qsvc_tpu_torch.mctf import motion_coding, transform
    swaps = [(transform, "analyze_jit", transform.analyze),
             (transform, "synthesize_jit", transform.synthesize),
             (motion_coding, "decorrelate_jit", motion_coding.decorrelate),
             (motion_coding, "correlate_jit", motion_coding.correlate),
             (frame_codec, "_encode_device_jit", frame_codec._encode_device),
             (frame_codec, "_dequant_idwt_jit", frame_codec._dequant_idwt)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def profile_run(fn):
    """One call of ``fn`` under ``torch.profiler``, ended by a
    synchronise: (wall s, device busy s as the union of the device's
    kernel, copy and fill intervals, host launches as the CUDA runtime
    launch calls (kernels and graphs), device operations)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith("cu") and "Launch" in e.name)
    return wall, busy * 1e-6, launches, len(spans)


def _same(a, b):
    a, b = list(a), list(b)
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))


def _flat_stream(st):
    return [st.low_y, st.low_u, st.low_v] + [a for lev in st.levels
                                             for a in lev]


def _gop_programs(planes, cfg, dev, jit):
    """Every captured program on one flagship GOP as the API calls it
    (``jit``) or its eager function: {name: list of result tensors}.
    Stage 1 runs on the luma stack and ``_dequant_idwt`` on the quantized
    level-1 lumas, as encode and decode give them."""
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec import frame_codec
    from qsvc_tpu_torch.mctf import motion_coding, transform
    pick = (lambda j, e: j) if jit else (lambda j, e: e)
    out = {}
    st = pick(transform.analyze_jit, transform.analyze)(*planes, cfg)
    out["analyze"] = _flat_stream(st)
    levels = cfg.SRLs - 1
    delta = api._operating_point(cfg, False, None, None)[0]
    d = torch.tensor(delta, dtype=torch.float32, device=dev)
    luma = torch.cat([st.low_y] + [lev.high_y for lev in st.levels])
    N, H, W = luma.shape
    tpl = frame_codec._tile_template(H, W, levels, cfg.codeblock_size)
    thr = np.full(N, frame_codec.slope_to_threshold(cfg.slopes()[0][0]))
    ms = torch.as_tensor(frame_codec._slope_floor(
        thr, N, len(tpl), tpl, False, delta, cfg.texture_coder), device=dev)
    out["stage 1"] = list(pick(frame_codec._encode_device_jit,
                               frame_codec._encode_device)(
        luma, d, *frame_codec._tile_dims_on(H, W, levels,
                                            cfg.codeblock_size, N, dev),
        ms, levels, False, cfg.codeblock_size))
    mvs = [lev.mv for lev in st.levels]
    res = pick(motion_coding.decorrelate_jit, motion_coding.decorrelate)(mvs)
    out["decorrelate"] = res
    out["correlate"] = pick(motion_coding.correlate_jit,
                            motion_coding.correlate)(res)
    q = frame_codec._dwt_quant(st.levels[0].high_y, levels, False, d)
    out["dequant_idwt"] = [pick(frame_codec._dequant_idwt_jit,
                                frame_codec._dequant_idwt)(
        q, levels, False, d)]
    for k in (0, 1):
        sub = st._replace(levels=st.levels[k:])
        out[f"synthesize discard {k}"] = list(pick(
            transform.synthesize_jit, transform.synthesize)(sub, cfg, k))
    return out


def phase_graphs(dev):
    """9: the captured programs at the flagship size (1920x1088, TRLs 5,
    9/7 at 45000): each equal to its eager run bit for bit on GOP 1 (the
    first call: warm-up, capture, replay) and on GOP 2 through GOP 1's
    graphs (stale inputs); GOP 1's results unchanged after GOP 2's
    replays (aliasing); ``expand_gops`` over 4 GOPs in its two threads
    == the serial ``expand``; the launches of one encode and decode of 4
    GOPs through the graphs == those of the eager programs; capture
    seconds and peak memory per key; the decode's device busy share and
    host launches, eager and replayed."""
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec.codestream import VideoStream
    from qsvc_tpu_torch.io import Video, synthetic_video
    from qsvc_tpu_torch.ops import cuda_lib
    from qsvc_tpu_torch.utils import graphs

    t_start = time.time()
    graphs.clear()              # and with the last graph, its pool:
    torch.cuda.empty_cache()    # the peaks below are this phase's own
    cfg = _flagship_cfg()
    gop_cfg = cfg.replace(GOPs=1)
    vid = synthetic_video(cfg.pictures, FLAGSHIP_H, FLAGSHIP_W, seed=0)
    S = cfg.gop_size
    staged = [Video(*(torch.from_numpy(p[g * S:(g + 1) * S + 1]).to(dev)
                      for p in vid.planes())) for g in range(cfg.GOPs)]
    # GOP 1: every program's first call, with its peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    first = _gop_programs(staged[0].planes(), gop_cfg, dev, jit=True)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    peak_reserved = torch.cuda.max_memory_reserved() / 2**30
    kept = {k: [t.clone() for t in v] for k, v in first.items()}
    want1 = _gop_programs(staged[0].planes(), gop_cfg, dev, jit=False)
    bad = [k for k in first if not _same(first[k], want1[k])]
    if bad:
        raise SystemExit(f"phase 9: replay != eager on GOP 1: {bad}")
    del want1
    n_graphs = len(graphs.stats())
    second = _gop_programs(staged[1].planes(), gop_cfg, dev, jit=True)
    want2 = _gop_programs(staged[1].planes(), gop_cfg, dev, jit=False)
    bad = [k for k in second if not _same(second[k], want2[k])]
    if bad:
        raise SystemExit(f"phase 9: GOP 2 through GOP 1's graphs != eager "
                         f"(stale inputs): {bad}")
    if len(graphs.stats()) != n_graphs:
        raise SystemExit("phase 9: GOP 2 captured new graphs")
    bad = [k for k in first if not _same(first[k], kept[k])]
    if bad:
        raise SystemExit(f"phase 9: GOP 1's results changed after GOP 2's "
                         f"replays (aliasing): {bad}")
    del first, second, want2, kept
    keys = "; ".join(
        f"{g['name']} {g['shapes'][0]} warm-up {g['warmup_s']:.3f} s, "
        f"capture {g['capture_s']:.3f} s, launches {g['launches']}"
        for g in graphs.stats())
    print(f"  9a flagship GOP programs (analyze, stage 1, decorrelate, "
          f"correlate, dequant_idwt, synthesize at discard 0 and 1): replay "
          f"== eager bit for bit on GOP 1 (first call) and GOP 2 (GOP 1's "
          f"graphs), GOP 1's results unchanged after GOP 2; {n_graphs} "
          f"graphs, first calls' peak {peak:.3f} GiB allocated above the "
          f"staged frames, {peak_reserved:.3f} GiB reserved in all; "
          f"{keys}",
          flush=True)

    # launches of one encode and decode: through the graphs == eager
    def encode_decode():
        cuda_lib.reset_launches()
        streams = api.compress_chunks(staged, gop_cfg, reversible=False,
                                      device=dev)
        enc = dict(cuda_lib.launches)
        parsed = [VideoStream.from_bytes(s.to_bytes()) for s in streams]
        cuda_lib.reset_launches()
        for p in parsed:
            api.expand(p, to_host=False, device=dev)
        return parsed, enc, dict(cuda_lib.launches)
    encode_decode()                        # captures what 9a did not
    parsed, enc_g, dec_g = encode_decode()
    with _eager_programs():
        parsed_e, enc_e, dec_e = encode_decode()
    if (enc_g, dec_g) != (enc_e, dec_e):
        raise SystemExit(f"phase 9: launches through the graphs {enc_g} / "
                         f"{dec_g} != eager {enc_e} / {dec_e}")
    if [p.to_bytes() for p in parsed] != [p.to_bytes() for p in parsed_e]:
        raise SystemExit("phase 9: the encode through the graphs differs "
                         "from the eager programs' bytes")

    # expand_gops' two threads == the serial expand
    graphs.clear()               # its threads capture, too
    par = api.expand_gops(parsed, device=dev)
    ser = [api.expand(p, device=dev) for p in parsed]
    for c in "yuv":
        parts = [getattr(v, c) for v in ser]
        want = np.concatenate([p[:-1] for p in parts] + [parts[-1][-1:]])
        if not np.array_equal(getattr(par, c), want):
            raise SystemExit(f"phase 9: expand_gops in two threads differs "
                             f"from the serial expand ({c})")

    def decode():
        for p in parsed:
            api.expand(p, to_host=False, device=dev)
    decode()
    rows = []
    for name in ("replayed", "eager", "replayed ", "eager "):
        if name.startswith("eager"):
            with _eager_programs():
                decode()
                r = profile_run(decode)
        else:
            r = profile_run(decode)
        rows.append(f"{name.strip()} wall {r[0]:.4f} s, device busy "
                    f"{r[1]:.4f} s ({r[1] / r[0]:.1%}), host launches "
                    f"{r[2]}, device ops {r[3]}")
    print(f"  9b launches per 4-GOP encode {enc_g} and decode {dec_g}, "
          f"through the graphs == eager, same bytes; expand_gops (2 "
          f"threads) == serial expand; decode of 4 GOPs under "
          f"torch.profiler: {'; '.join(rows)}", flush=True)
    print(f"phase 9 captured programs: ok; phase "
          f"{time.time() - t_start:.3f} s", flush=True)


def _contract_calls(dev, vid):
    """Each function that keeps the JAX contract, called the JAX way at
    the flagship's width, on the card (``dev``) and on the CPU with the
    same inputs: {name: (card result, CPU result)}, and the K2 launches
    of ``predict_frame`` and ``predict_frames_subpixel`` on the card."""
    from qsvc_tpu_torch.codec import frame_codec
    from qsvc_tpu_torch.mctf import predict, update
    from qsvc_tpu_torch.ops import blocks, border, cuda_lib, entropy
    rng = np.random.default_rng(10)
    y, u, v = (torch.from_numpy(p[:3].astype(np.int16)) for p in
               vid.planes())
    by, bx = FLAGSHIP_H // FLAGSHIP_BS, FLAGSHIP_W // FLAGSHIP_BS
    # level 1's search range 4: vectors up to 5, edge padding 16; the
    # sub-pixel prediction's (a = 1) in half pixels
    mv = torch.from_numpy(rng.integers(-5, 6, (2, 2, by, bx))
                          .astype(np.int32))
    mv_half = torch.from_numpy(rng.integers(-9, 10, (1, 2, 2, by, bx))
                               .astype(np.int32))
    pad = 4 * 4
    sy = (torch.arange(by)[:, None] * FLAGSHIP_BS + mv[0, 0] + pad)
    sx = (torch.arange(bx)[None, :] * FLAGSHIP_BS + mv[0, 1] + pad)
    planes = np.ascontiguousarray(vid.y[:1])
    efs = frame_codec.encode_frames(planes, 4, True, 0.125, 64, 0.0, "bp",
                                    device=dev)
    thr = np.zeros(1)

    def calls(d):
        def on(x):
            return x.to(d)
        out = {}
        frames = [tuple(on(p[i]) for p in (y, u, v)) for i in range(3)]
        out["histogram_entropy"] = entropy.histogram_entropy(frames[0][0])
        prev = predict.refs_to_444(frames[0])
        nxt = predict.refs_to_444(frames[2])
        out["refs_to_444"] = prev
        out["predict_frame"] = pred = predict.predict_frame(
            prev, nxt, on(mv), FLAGSHIP_BS, pad)
        out["predict_frames_subpixel"] = predict.predict_frames_subpixel(
            prev[None], nxt[None], on(mv_half), FLAGSHIP_BS, 4, 1)
        out["decorrelate_from_pred"] = res = predict.decorrelate_from_pred(
            frames[1], pred, on(mv))
        out["correlate_from_pred"] = predict.correlate_from_pred(
            res[:3], pred, res.is_B)
        out["residue_to_444"] = update.residue_to_444(res[:3], res.is_B)
        patches = blocks.gather_block_patches(
            border.pad_edge(prev, pad), on(sy), on(sx), FLAGSHIP_BS,
            FLAGSHIP_BS)
        out["gather_block_patches"] = patches
        out["blocks_to_image"] = blocks.blocks_to_image(patches)
        pend = frame_codec.encode_frames_dispatch_sparse(
            on(torch.from_numpy(planes)), 4, True, 0.125, 64, thr)
        sel = frame_codec.encode_frames_select_sparse(pend, thr)
        out["encode_frames_select_sparse"] = (
            sel[0], sel[1], torch.from_numpy(sel[2]),
            torch.from_numpy(sel[3][2]))
        out["decode_frames"] = torch.from_numpy(
            frame_codec.decode_frames(efs, device=d))
        return out
    cuda_lib.reset_launches()
    card = calls(dev)
    k2 = cuda_lib.launches["mc_predict"]
    cpu = calls(torch.device("cpu"))
    return {k: (card[k], cpu[k]) for k in card}, k2


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    return [x]


def phase_contract(dev):
    """10: (a) each function that keeps the JAX contract, called the JAX
    way at the flagship's width on the card, equal to the CPU call (bit
    for bit; ``histogram_entropy``'s float32 entropy within rtol 1e-6,
    with its difference printed), ``predict_frame`` through K2; (b) the
    cold start of the flagship's first GOP: encode (``compress_chunks``)
    and decode (``expand_gops``) walls after ``graphs.clear()``, without
    and with ``prewarm`` / ``prewarm_decode``, in turns, with the
    prewarms' seconds and the graphs each first GOP captured (0 after a
    prewarm, or the phase fails); (c) ``api.compress(video, cfg)`` without
    ``device`` runs on the card: it launches the kernels and gives the
    bytes of the card's ``compress_chunks``."""
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec.codestream import VideoStream
    from qsvc_tpu_torch.io import Video, synthetic_video
    from qsvc_tpu_torch.ops import cuda_lib
    from qsvc_tpu_torch.utils import graphs

    t_start = time.time()
    cfg = _flagship_cfg()
    gop_cfg = cfg.replace(GOPs=1)
    vid = synthetic_video(gop_cfg.pictures, FLAGSHIP_H, FLAGSHIP_W, seed=0)

    results, k2 = _contract_calls(dev, vid)
    diffs = {}
    for name, (card, cpu) in results.items():
        for a, b in zip(_leaves(card), _leaves(cpu)):
            if isinstance(a, torch.Tensor):
                a = a.cpu()
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise SystemExit(f"phase 10: {name} on the card gives "
                                     f"{a.dtype} {tuple(a.shape)}, on the "
                                     f"CPU {b.dtype} {tuple(b.shape)}")
                if name == "histogram_entropy":
                    diffs[name] = float((a - b).abs())
                    ok = diffs[name] <= 1e-6 * float(b.abs())
                else:
                    ok = torch.equal(a, b)
            else:
                ok = a == b
            if not ok:
                raise SystemExit(f"phase 10: {name} on the card differs "
                                 f"from the CPU")
    if k2 < 2:
        raise SystemExit(f"phase 10: predict_frame and "
                         f"predict_frames_subpixel launched K2 {k2} times")
    print(f"  10a JAX-contract functions at {FLAGSHIP_W}x{FLAGSHIP_H}, "
          f"card == CPU: "
          f"{', '.join(sorted(results))}; bit for bit but "
          f"histogram_entropy (|card - CPU| "
          f"{diffs['histogram_entropy']:.3g} bits); K2 launches "
          f"{k2}", flush=True)

    S = gop_cfg.gop_size
    staged = Video(*(torch.from_numpy(p[:S + 1]).to(dev)
                     for p in vid.planes()))
    rows = []
    for warm in (False, True, False, True):
        graphs.clear()
        torch.cuda.empty_cache()
        pre_e = (api.prewarm(cfg, reversible=False, device=dev) if warm
                 else 0.0)
        n0 = len(graphs.stats())
        streams, enc_s = _timed(lambda: api.compress_chunks(
            [staged], gop_cfg, reversible=False, device=dev))
        new_e = len(graphs.stats()) - n0
        parsed = [VideoStream.from_bytes(s.to_bytes()) for s in streams]
        graphs.clear()
        torch.cuda.empty_cache()
        pre_d = (api.prewarm_decode(parsed[0].cfg, reversible=False,
                                    delta=parsed[0].delta or None,
                                    device=dev) if warm else 0.0)
        n0 = len(graphs.stats())
        _, dec_s = _timed(lambda: api.expand_gops(parsed, device=dev))
        new_d = len(graphs.stats()) - n0
        if warm and (new_e or new_d):
            raise SystemExit(f"phase 10: the first GOP after prewarm "
                             f"captured {new_e} encode and {new_d} decode "
                             f"graphs")
        rows.append(f"{'with' if warm else 'without'} prewarm: encode "
                    f"{enc_s:.3f} s ({new_e} graphs captured; prewarm "
                    f"{pre_e:.3f} s), decode {dec_s:.3f} s ({new_d} "
                    f"captured; prewarm_decode {pre_d:.3f} s)")
    print(f"  10b first flagship GOP after graphs.clear(), in turns: "
          f"{'; '.join(rows)}", flush=True)

    lossy = streams[0].to_bytes()
    cuda_lib.reset_launches()
    data = api.compress(vid, gop_cfg, reversible=False).to_bytes()
    counts = dict(cuda_lib.launches)
    if data != lossy or not all(counts.get(k) for k in SEQUENTIAL_KERNELS):
        raise SystemExit(f"phase 10: api.compress(video, cfg) without a "
                         f"device gave {len(data)} bytes (the card's "
                         f"compress_chunks {len(lossy)}), launches "
                         f"{counts}")
    print(f"  10c api.compress(video, cfg) without a device: on the card, "
          f"launches {counts}, == compress_chunks on the card "
          f"({len(data)} bytes)", flush=True)
    print(f"phase 10 JAX contract and cold start: ok; phase "
          f"{time.time() - t_start:.3f} s", flush=True)


def _bench_process():
    """Start ``python3 -m qsvc_tpu_torch.tools.bench`` from the root of
    this checkout, its output to temporary files: (process, stdout,
    stderr)."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m",
                             "qsvc_tpu_torch.tools.bench"],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=out, stderr=err, text=True)
    return proc, out, err


def _bench_row(proc, out, err, flagship_quality):
    """Wait for the bench process; its JSON row, after checking its exit
    code, its keys and that its bpp and PSNR-Y are phase 4's."""
    with out, err:
        try:
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        err.seek(0)
        lines = out.read().strip().splitlines()
        errors = err.read()
    if rc != 0 or not lines or not lines[-1].startswith("{"):
        tail = "\n".join(lines[-5:])
        raise SystemExit(f"phase 11a: the bench exited {rc}:\n{tail}\n"
                         f"{errors[-3000:]}")
    row = json.loads(lines[-1])
    keys = set(row) | {f"detail.{k}" for k in row.get("detail", {})}
    if keys != BENCH_KEYS:
        raise SystemExit(f"phase 11a: the bench's keys differ: missing "
                         f"{sorted(BENCH_KEYS - keys)}, extra "
                         f"{sorted(keys - BENCH_KEYS)}")
    got = (row["detail"]["bpp"], row["detail"]["psnr_y"])
    if got != flagship_quality:
        raise SystemExit(f"phase 11a: the bench's bpp and PSNR-Y {got} are "
                         f"not phase 4's {flagship_quality}")
    return row, lines[-2]


def _rd_curves(dev):
    """The RD harness's curves of ``translate_int`` and ``translate_frac``,
    both coders, on the card, each MCTF point held to the CPU's (bytes
    within 1 %, PSNR-Y within 0.05 dB) and ``translate_int``'s mid-rate
    advantages to their bounds; returns one summary per curve and the
    launches of the card's curves."""
    from qsvc_tpu_torch.config import CodecConfig
    from qsvc_tpu_torch.ops import cuda_lib
    from qsvc_tpu_torch.tools import rd_harness

    cfg = CodecConfig(**rd_harness.CONFIG)
    videos = rd_harness.sequences(cfg)
    rows, bad = [], []
    cuda_lib.reset_launches()
    for name in rd_harness.TRANSLATE:
        c = cfg.replace(subpixel_accuracy=rd_harness.SUBPIXEL.get(name, 0))
        for coder in ("bp", "mq"):
            card = rd_harness.curve_for(videos[name], c, coder,
                                        rd_harness.SLOPES, device=dev)
            _, cpu = rd_harness.mctf_points(videos[name], c, coder,
                                            rd_harness.SLOPES, device="cpu")
            for p, q in zip(card["points"], cpu):
                if (abs(p["mctf_bytes"] - q.bytes) > 0.01 * q.bytes
                        or abs(p["mctf_psnr_y"] - q.psnr_y) > 0.05):
                    bad.append(f"{name} {coder} slope {q.quantization:.0f}: "
                               f"card {p['mctf_bytes']} B "
                               f"{p['mctf_psnr_y']:.3f} dB, CPU {q.bytes} B "
                               f"{q.psnr_y:.3f} dB")
            adv = rd_harness.midrate_advantages(card)
            if name == "translate_int" and min(adv) < RD_MIN_ADVANTAGE[coder]:
                bad.append(f"{name} {coder}: mid-rate advantage {adv} dB < "
                           f"{RD_MIN_ADVANTAGE[coder]} dB")
            psnr = [round(p["mctf_psnr_y"], 3) for p in card["points"]]
            rows.append(f"{name} {coder} bytes "
                        f"{[p['mctf_bytes'] for p in card['points']]} "
                        f"(CPU {[q.bytes for q in cpu]}), PSNR-Y {psnr}, "
                        f"mid-rate advantage {[round(a, 3) for a in adv]} "
                        f"dB")
    if bad:
        raise SystemExit(f"phase 11b: RD on the card: {bad}")
    return rows, dict(cuda_lib.launches)


def phase_tools(dev, flagship_quality):
    """11: the port's measurement entries: (a) ``python3 -m
    qsvc_tpu_torch.tools.bench`` in a process of its own, which must exit
    0 with ``bench.py``'s keys (two renamed) and phase 4's bpp and PSNR-Y;
    (b) meanwhile, in this process, the RD harness's curves of the two
    translating sequences, both coders, on the card against the CPU (its
    encode times and the bench's fps are not measurements: the two share
    the card and the host)."""
    t_start = time.time()
    torch.cuda.empty_cache()        # room for the bench's process
    proc, out, err = _bench_process()
    try:
        rows, launches = _rd_curves(dev)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    row, launch_line = _bench_row(proc, out, err, flagship_quality)
    missing = [k for k in SEQUENTIAL_KERNELS if not launches.get(k)]
    if missing:
        raise SystemExit(f"phase 11b: the RD curves on the card never "
                         f"launched {missing}: {launches}")
    print(f"  11a python3 -m qsvc_tpu_torch.tools.bench: exit 0, its keys, "
          f"bpp and PSNR-Y == phase 4's; {launch_line}; its row:",
          flush=True)
    print(json.dumps(row), flush=True)
    print(f"  11b RD harness curves on the card == CPU (bytes 1 %, PSNR-Y "
          f"0.05 dB), launches {launches}: {'; '.join(rows)}", flush=True)
    print(f"phase 11 measurement entries: ok; phase "
          f"{time.time() - t_start:.3f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.time()
    phase_setup()
    parity = phase_kernel_parity(dev)
    phase_correctness(dev)
    counts, flagship_quality = phase_flagship(dev)
    counts = {k: v for k, v in counts.items() if k in SEQUENTIAL_KERNELS}
    counts["mc_update1"] = phase_sharded(dev)["mc_update1"]
    phase_halo(dev)
    phase_nccl()
    phase_subpixel(dev)
    phase_surface(dev)
    for name, n in phase_rest(dev).items():
        if name in counts:
            counts[name] += n
    phase_graphs(dev)
    phase_contract(dev)
    phase_tools(dev, flagship_quality)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts.get(name, 0),
                "max_abs_err": parity[name][0], "ms": parity[name][1],
                "plain_ms": parity[name][2], "bound_ms": parity[name][3][0],
                "bound_by": parity[name][3][1], "library_ms": None}
               for name, (src, replaces) in KERNEL_SOURCES.items()]
    bad = [k["name"] for k in kernels
           if k["launches"] == 0 or k["max_abs_err"] != 0]
    if bad:
        raise SystemExit(f"kernels not launched on their path or inexact: "
                         f"{bad}")
    print(f"total {time.time() - t_start:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    # phases 5c and 8d use every visible card, the others the one of `dev`
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
