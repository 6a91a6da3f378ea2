"""Smoke run of the PyTorch/CUDA port (``qsvc_tpu_torch``) on one GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the last line:

1. set-up: the card's name and power limit, then the build of the CUDA
   kernels (``qsvc_tpu_torch/csrc``) and of the native EBCOT coder;
2. kernel parity at the flagship shapes: K1 (spiral SAD refinement) at
   every pyramid depth of temporal levels 1 and 4, K2 (MC predict), K3
   (MC update, both directions) and K4 (MC update, one direction, at
   search ranges 32 and 4) at 8 pairs of 1088x1920x3 — each kernel
   against its plain PyTorch version on the same card, exact equality,
   with CUDA-event times (median of several calls after a warm-up);
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
5a for K4); the last line is ``{"ok": true, "device": {...}}`` with the
number of cards the run used.  Without a CUDA device
the script exits 1 and prints no result.
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
#: the kernels the sequential flagship (phase 4) must launch; K4 runs on
#: the sharded path (phase 5a)
SEQUENTIAL_KERNELS = ("me_refine", "mc_predict", "mc_update2")


def _ceil_half(x, times):
    for _ in range(times):
        x = (x + 1) // 2
    return x


def _cuda_ms(fn, reps=7, warmup=2):
    """Median CUDA-event time of one call, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_err(a, b):
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


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


def phase_kernel_parity(dev):
    from qsvc_tpu_torch.mctf import me, predict, update
    from qsvc_tpu_torch.ops import cuda_mc, cuda_me
    rng = np.random.default_rng(0)
    H, W, bs = 1088, 1920, 64
    results = {}

    def rand_planes(shape, lo=0, hi=256, dtype=np.int16):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)
                                ).to(dev)

    # K1 at every pyramid depth of temporal level 1 (P=8, search 4) and
    # level 4 (P=1, search 32), as estimate_sequence calls it
    k1_err, k1_main = 0.0, None
    for P, sr in ((8, 4), (1, 32)):
        depths = max(int(round(np.log2(sr))) - 1, 0)
        for d in range(depths + 1):
            ny, nx = _ceil_half(H, d), _ceil_half(W, d)
            By, Bx = _ceil_half(H // bs, d), _ceil_half(W // bs, d)
            pr, pv, nx_ = (rand_planes((P, ny, nx)) for _ in range(3))
            # motion estimation returns |mv| <= sr + 1: one past the pad
            mv = rand_planes((P, 2, 2, By, Bx), -sr - 1, sr + 2, np.int32)
            got = mv + cuda_me.refine(pr, pv, nx_, mv, bs, 0, ny, nx,
                                      sr).view(mv.shape)
            want = me._refine_level(pr, pv, nx_, mv, bs, 0, ny, nx, sr)
            err = _max_err(got, want)
            k1_err = max(k1_err, err)
            ms = _cuda_ms(lambda: cuda_me.refine(pr, pv, nx_, mv, bs, 0,
                                                 ny, nx, sr))
            pms = _cuda_ms(lambda: me._refine_level(pr, pv, nx_, mv, bs, 0,
                                                    ny, nx, sr), reps=3)
            print(f"  K1 P={P} sr={sr} depth {d} ({ny}x{nx}, {By}x{Bx} "
                  f"blocks): max_abs_err {err}, kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms", flush=True)
            if k1_main is None:
                k1_main = (ms, pms)
    results["me_refine"] = (k1_err,) + k1_main

    # K2 and K3 at 8 pairs of 3 x 1088 x 1920, |mv| <= 33
    P, C, sr = 8, 3, 32
    By, Bx = H // bs, W // bs
    prev, nxt = rand_planes((P, C, H, W)), rand_planes((P, C, H, W))
    mv = rand_planes((P, 2, 2, By, Bx), -sr - 1, sr + 2, np.int32)
    got = cuda_mc.predict(prev, nxt, mv, bs, 4 * sr)
    want = predict.predict_frame(prev, nxt, mv, bs, 4 * sr)
    err = _max_err(got, want)
    ms = _cuda_ms(lambda: cuda_mc.predict(prev, nxt, mv, bs, 4 * sr))
    pms = _cuda_ms(lambda: predict.predict_frame(prev, nxt, mv, bs, 4 * sr),
                   reps=3)
    print(f"  K2 P={P} C={C} {H}x{W}: max_abs_err {err}, kernel {ms:.4f} "
          f"ms, plain {pms:.4f} ms", flush=True)
    results["mc_predict"] = (err, ms, pms)

    contrib = rand_planes((P, C, H, W), -32, 32)
    got = cuda_mc.update2(contrib, mv, bs, sr)

    def plain_update():
        return torch.stack([update._update_sums(contrib, mv[:, d, 0],
                                                mv[:, d, 1], bs, sr)
                            for d in range(2)], dim=1)
    err = _max_err(got, plain_update())
    ms = _cuda_ms(lambda: cuda_mc.update2(contrib, mv, bs, sr))
    pms = _cuda_ms(plain_update, reps=3)
    print(f"  K3 P={P} C={C} {H}x{W}: max_abs_err {err}, kernel {ms:.4f} "
          f"ms, plain {pms:.4f} ms", flush=True)
    results["mc_update2"] = (err, ms, pms)

    # K4, one direction as the sharded MCTF calls it, at the search
    # ranges of flagship levels 4 (32) and 1 (4); the first is the row
    k4 = []
    for sr in (32, 4):
        mvy, mvx = (rand_planes((P, By, Bx), -sr - 1, sr + 2, np.int32)
                    for _ in range(2))

        def kernel(mvy=mvy, mvx=mvx, sr=sr):
            return cuda_mc.update1(contrib, mvy, mvx, bs, sr)

        def plain(mvy=mvy, mvx=mvx, sr=sr):
            return update._update_sums(contrib, mvy, mvx, bs, sr)
        err = _max_err(kernel(), plain())
        ms = _cuda_ms(kernel)
        pms = _cuda_ms(plain, reps=3)
        print(f"  K4 P={P} C={C} {H}x{W} sr={sr}: max_abs_err {err}, kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms", flush=True)
        k4.append((err, ms, pms))
    results["mc_update1"] = (max(e for e, _, _ in k4),) + k4[0][1:]

    bad = {k: v[0] for k, v in results.items() if v[0] != 0}
    if bad:
        raise SystemExit(f"phase 2 kernel parity FAILED: {bad}")
    print("phase 2 kernel parity: ok (K1, K2, K3, K4 exact vs plain "
          "versions)", flush=True)
    return results


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
    torch.cuda.synchronize()
    t0 = time.time()
    streams = api.compress_chunks(staged, gop_cfg, reversible=False,
                                  device=dev)
    enc_s = time.time() - t0
    blobs = [s.to_bytes() for s in streams]
    parsed = [VideoStream.from_bytes(b) for b in blobs]
    for s in parsed:                        # decode warm-up
        api.expand(s, to_host=False, device=dev)
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
          f"{pv:.3f} dB, launches {counts}", flush=True)
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
                "plain_ms": parity[name][2]}
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
