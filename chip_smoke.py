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
   to search range + 1 — each kernel against its plain PyTorch version
   on the same card, exact equality, with CUDA-event times (batches of
   calls back to back, after a warm-up) beside the kernel's bound;
3. correctness on the card: the MCTF analysis of a small sequence on the
   card equals the plain CPU run, and a 1080p lossless 5/3 MCTF stream
   round-trips bit-exactly through its container bytes;
4. the flagship: 1920x1088, GOP 16 (TRLs=5), 9/7 at slope 45000, 4 GOPs
   staged on the card, encoded (warm-up + timed) and decoded to
   device-resident uint8, with the kernel launch counts of that run;
5a. the sharded flagship on one rank (``qsvc_tpu_torch.parallel``): the
   phase 4 configuration as one 65-frame sequence, ``compress_distributed``
   byte-identical to ``api.compress`` and ``encode_gops_distributed`` to
   ``api.compress_gops``; that encode launches K4 and not K3; warm wall
   times of the sharded and the sequential encode, for information;
5b. the halo exchange on the card: a ``gloo`` group of 2 spawned
   processes, both on this card (NCCL takes one rank per card), encodes
   2 GOPs of 1920x1088 losslessly; both ranks' ``compress_distributed``
   bytes equal the sequential encode's, their ``synthesize_sharded``
   frames equal the sequential synthesis, and each rank launched K4.

The second-to-last line is a JSON object with one entry per kernel
(launches counted on that kernel's main path: phase 4 for K1-K3, phase
5a for K4; times and bound at the first shape phase 2 names for it);
the last line is ``{"ok": true, "device": {...}}`` with the number of
cards the run used.  Without a CUDA device the script exits 1 and
prints no result.

A kernel's bound is the least time the card could take for its work:
the larger of the bytes it must move (each input read once, each output
written once) over the H100's 3.35 TB/s, and its operations over their
rate below: int32 for K2-K4, and for K1 two fp32 lane operations per SAD
term (a subtraction and an addition of an absolute value, exact in fp32
while no int16 difference wraps).  No single PyTorch call computes
K1-K4, so ``library_ms`` is null.
"""

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


def k1_calls(dev, refine, variants=None, seed=0):
    """K1 at each of its 14 calls in one flagship GOP: every pyramid depth
    of every temporal level, at the shapes ``me.estimate_sequence`` gives
    it (random 0..255 planes, |mv| <= search range + 1, one past the
    pad), then once more at level 1, depth 0, over the full int16 range
    (the kernel's wrap-around path; not part of the GOP).

    ``refine(pred, prev, next, mv, bs, ny, nx, sr)`` returns the refined
    vectors; each call must equal ``me._refine_level`` exactly.
    ``variants`` ({label: refine}) are checked and timed beside it.
    Returns one dict per call: label, gop (a call of the GOP), max_abs_err,
    ms (device time, CUDA graph), eager_ms (back-to-back calls), plain_ms,
    bound (ms, by) and {label: ms} of the variants."""
    from qsvc_tpu_torch.mctf import me
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
        pr, pv, nxt = (torch.from_numpy(rng.integers(
            lo, hi, (P, ny, nx)).astype(np.int16)).to(dev) for _ in range(3))
        mv = torch.from_numpy(rng.integers(
            -sr - 1, sr + 2, (P, 2, 2, By, Bx)).astype(np.int32)).to(dev)
        want = me._refine_level(pr, pv, nxt, mv, bs, 0, ny, nx, sr)
        fns = {"": refine, **(variants or {})}
        err = max(_max_err(f(pr, pv, nxt, mv, bs, ny, nx, sr), want)
                  for f in fns.values())
        ms = {k: _graph_ms(lambda f=f: f(pr, pv, nxt, mv, bs, ny, nx, sr))
              for k, f in fns.items()}
        eager = _cuda_ms(lambda: refine(pr, pv, nxt, mv, bs, ny, nx, sr))
        plain = _cuda_ms(lambda: me._refine_level(pr, pv, nxt, mv, bs, 0,
                                                  ny, nx, sr),
                         reps=3, batch=2)
        # the least work: 18 probes (9 per reference) of |a - b| summed
        # over bs^2 pixels, one subtraction and one addition of an
        # absolute value per term, both exact on the fp32 lanes while the
        # int16 differences cannot wrap (fp32 add with an |x| operand);
        # the bytes: the three planes, mv and the refined mv, each once
        bound = _bound(_nbytes(pr, pv, nxt, mv, want),
                       P * By * Bx * 18 * bs * bs * 2, FP32_OPS_PER_S)
        label = (f"L{lvl} P={P} sr={sr} depth {d}"
                 + (" full int16" if lo < 0 else ""))
        rows.append({"label": label, "gop": lo == 0, "max_abs_err": err,
                     "ms": ms.pop(""), "eager_ms": eager, "plain_ms": plain,
                     "bound": bound, "variants": ms})
        r = rows[-1]
        extra = "".join(f", {k} {v:.4f} ms" for k, v in ms.items())
        print(f"  K1 {label} ({ny}x{nx}, {By}x{Bx} blocks, {P * By * Bx} "
              f"blocks in all): max_abs_err {err}, kernel {r['ms']:.4f} ms "
              f"({bound[0] / r['ms']:.0%} of its {bound[0]:.4f} ms "
              f"{bound[1]} bound), back to back {eager:.4f} ms{extra}, "
              f"plain {plain:.4f} ms", flush=True)
    gop = [r for r in rows if r["gop"]]
    print(f"  K1 per flagship GOP ({len(gop)} calls): kernel "
          f"{sum(r['ms'] for r in gop):.4f} ms, back to back "
          f"{sum(r['eager_ms'] for r in gop):.4f} ms, bound "
          f"{sum(r['bound'][0] for r in gop):.4f} ms", flush=True)
    return rows


def phase_kernel_parity(dev):
    from qsvc_tpu_torch.ops import cuda_me
    rng = np.random.default_rng(0)
    H, W, bs = FLAGSHIP_H, FLAGSHIP_W, FLAGSHIP_BS
    results = {}

    def rand_planes(shape, lo=0, hi=256, dtype=np.int16):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)
                                ).to(dev)

    def refine(pr, pv, nxt, mv, bs, ny, nx, sr, split=None):
        return cuda_me.refine(pr, pv, nxt, mv, bs, 0, ny, nx, sr, split)
    # beside the wrapper's choice of cluster size: one CTA per block
    k1 = k1_calls(dev, refine, {"one CTA per block": lambda *a: refine(
        *a, split=1)})
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

    bad = {k: v[0] for k, v in results.items() if v[0] != 0}
    if bad:
        raise SystemExit(f"phase 2 kernel parity FAILED: {bad}")
    print("phase 2 kernel parity: ok (K1, K2, K3, K4 exact vs plain "
          "versions)", flush=True)
    return results


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


def _mc_parity(label, prev, nxt, contrib, mv, bs, sr):
    """K2, K3 and K4 (each direction) on one set of vectors, each exact
    against its plain version, with kernel, plain and bound times.
    Returns {name: (max_abs_err, ms, plain_ms, (bound_ms, bound_by))}."""
    from qsvc_tpu_torch.mctf import predict, update
    from qsvc_tpu_torch.ops import cuda_mc
    border = 4 * sr
    k2 = cuda_mc.predict(prev, nxt, mv, bs, border)
    rows = {"mc_predict": (
        _max_err(k2, predict.predict_frame(prev, nxt, mv, bs, border)),
        _cuda_ms(lambda: cuda_mc.predict(prev, nxt, mv, bs, border)),
        _cuda_ms(lambda: predict.predict_frame(prev, nxt, mv, bs, border),
                 reps=3, batch=2),
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

    # the kernels in context: MCTF analysis on the card == plain CPU run
    cfg = CodecConfig(pixels_in_x=256, pixels_in_y=128, TRLs=3, GOPs=1,
                      block_size=32, search_range=8, update_factor=0.25)
    vid = synthetic_video(cfg.pictures, 128, 256, seed=1, kind="translate")
    planes = [torch.from_numpy(p) for p in vid.planes()]
    on_card = transform.analyze(*(p.to(dev) for p in planes),
                                cfg).to_numpy()
    on_cpu = transform.analyze(*planes, cfg).to_numpy()
    flat_a = [on_card.low_y, on_card.low_u, on_card.low_v] + [
        a for lev in on_card.levels for a in lev]
    flat_b = [on_cpu.low_y, on_cpu.low_u, on_cpu.low_v] + [
        a for lev in on_cpu.levels for a in lev]
    if not all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b)):
        raise SystemExit("phase 3: MCTF on the card differs from the CPU")

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
    print(f"phase 3 correctness: ok (MCTF card == CPU at 256x128; 1080p "
          f"TRLs=3 lossless round trip bit-exact, {len(data)} bytes, "
          f"{dt:.3f} s)", flush=True)


def phase_flagship(dev):
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.codec.codestream import VideoStream
    from qsvc_tpu_torch.io import Video, synthetic_video, video_psnr
    from qsvc_tpu_torch.ops import cuda_lib

    cfg = _flagship_cfg()
    gops = cfg.GOPs
    vid = synthetic_video(cfg.pictures, 1088, 1920, seed=0)
    S = cfg.gop_size
    gop_cfg = cfg.replace(GOPs=1)
    staged = [Video(*(torch.from_numpy(p[g * S:(g + 1) * S + 1]).to(dev)
                      for p in vid.planes())) for g in range(gops)]
    torch.cuda.synchronize()

    cuda_lib.reset_launches()
    t0 = time.time()
    api.compress_chunks(staged, gop_cfg, reversible=False, device=dev)
    warm_s = time.time() - t0
    per_encode = dict(cuda_lib.launches)
    torch.cuda.synchronize()
    t0 = time.time()
    streams = api.compress_chunks(staged, gop_cfg, reversible=False,
                                  device=dev)
    enc_s = time.time() - t0
    blobs = [s.to_bytes() for s in streams]
    parsed = [VideoStream.from_bytes(b) for b in blobs]
    encoded = dict(cuda_lib.launches)
    for s in parsed:                        # decode warm-up
        api.expand(s, to_host=False, device=dev)
    per_decode = {k: n - encoded.get(k, 0)
                  for k, n in cuda_lib.launches.items()
                  if n > encoded.get(k, 0)}
    t0 = time.time()
    recs = [api.expand(s, to_host=False, device=dev) for s in parsed]
    dec_s = time.time() - t0
    counts = dict(cuda_lib.launches)

    def join(plane):
        parts = [getattr(r, plane).cpu().numpy() for r in recs]
        return np.concatenate([p[:-1] for p in parts] + [parts[-1][-1:]])
    rec = Video(join("y"), join("u"), join("v"))
    if rec.y.shape != vid.y.shape or rec.u.shape != vid.u.shape:
        raise SystemExit(f"phase 4: decoded shape {rec.y.shape}")
    py, pu, pv = video_psnr(vid, rec)
    bpp = sum(len(b) for b in blobs) * 8 / (vid.y.size * 3 // 2)
    missing = [k for k in SEQUENTIAL_KERNELS if counts.get(k, 0) == 0]
    print(f"phase 4 flagship 1920x1088 GOP16 x{gops}: encode "
          f"{vid.frames / enc_s:.3f} fps ({enc_s:.3f} s, warm-up "
          f"{warm_s:.3f} s), decode {vid.frames / dec_s:.3f} fps "
          f"({dec_s:.3f} s), {bpp:.5f} bpp, PSNR-Y/U/V {py:.3f}/{pu:.3f}/"
          f"{pv:.3f} dB, launches {counts} (per {gops}-GOP encode "
          f"{per_encode}, per decode {per_decode})", flush=True)
    if missing:
        raise SystemExit(f"phase 4: kernels never launched: {missing}")
    if not py >= 25.0:
        raise SystemExit(f"phase 4: PSNR-Y {py:.3f} dB < 25 dB")
    return counts


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


def _halo_rank(rank, world, store, outdir, device, cfg):
    """One rank of phase 5b (a process of torch.multiprocessing.spawn)."""
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
        np.savez(os.path.join(outdir, f"rank{rank}.npz"),
                 data=np.frombuffer(data, np.uint8),
                 launches=np.asarray(launches),
                 **{c: p.cpu().numpy() for c, p in zip("yuv", rec)})
        dist.barrier()      # no rank tears down while a peer still sends
    finally:
        dist.destroy_process_group()


def phase_halo(dev):
    """5b: two gloo ranks on this card against the sequential encode."""
    import torch.multiprocessing as mp
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.mctf import transform
    from qsvc_tpu_torch.parallel import mesh as pmesh

    cfg = _flagship_cfg(GOPs=2, quantization_texture=0)
    vid = _halo_video(cfg)
    world = 2
    card = f"cuda:{torch.cuda.current_device()}"
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        try:
            mp.spawn(_halo_rank, args=(world, os.path.join(tmp, "store"),
                                       tmp, card, cfg), nprocs=world,
                     join=True)
        except Exception as e:          # a rank failed: the phase fails
            raise SystemExit(f"phase 5b: a rank failed: {e}")
        ranks_s = time.time() - t0
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(world)]
    want = api.compress(vid, cfg, reversible=True, device=dev).to_bytes()
    for r, res in enumerate(ranks):
        if res["data"].tobytes() != want:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.time()
    phase_setup()
    parity = phase_kernel_parity(dev)
    phase_correctness(dev)
    counts = {k: v for k, v in phase_flagship(dev).items()
              if k in SEQUENTIAL_KERNELS}
    counts["mc_update1"] = phase_sharded(dev)["mc_update1"]
    phase_halo(dev)
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
    # every phase ran on the one card of `dev`
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
