"""The port's sharded flagship encode and decode across cards over nccl,
one rank per card, against the sequential ones on one card.

    python3 tools/nccl_halo.py [--ranks N] [--out FILE]

Spawns N ranks (default: every visible card), rank r on ``cuda:r``,
joined by ``nccl`` (``qsvc_tpu_torch.parallel.distributed.run_ranks``).
The video is the flagship's 4 GOPs (1920x1088, TRLs 5, block 64, search
4, update 1/4), its GOPs split over the ranks, in three runs:

* ``lossy``: 9/7 at slope 45000;
* ``subpixel2``: the same at sub-pixel accuracy 2;
* ``lossless``: reversible 5/3, and besides the encode each rank's
  ``synthesize_sharded`` of its own ``analyze_sharded`` chunk and
  ``encode_gops_distributed``.

In each run every rank calls ``compress_distributed`` once to warm up and
once timed, and returns the SHA-256 of its stream, its seconds with the
seconds of each traced stage (``utils.trace``), the kernel launches of
the timed call, the timed call's halo exchanges (its ``halo.exchange``
device spans, ``parallel.mesh.halo_totals``: their count, payload bytes
sent and received, and seconds between CUDA events around each
exchange), the seconds of one more
``analyze_sharded`` of its chunk alone, and its card's peak reserved
memory over the run.  This
process then runs the sequential counterparts on ``cuda:0``
(``api.compress`` warm-up and timed, ``api.compress_gops``, and
``transform.synthesize`` of the whole sequence cut into the ranks'
chunks) and checks that every rank's digests equal them.  Last,
``measure_scaling(N)`` of the flagship's GOP (TRLs 5, one GOP per rank).

Prints one JSON object, with the cards' names and power limits as
``nvidia-smi`` reads them, and writes it to FILE with ``--out``.  Exits
1 on any mismatch or without N cards.  ``check`` (the three runs without
the scaling) is what ``chip_smoke.py`` runs where it sees several cards.
"""

import argparse
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

#: run name -> (CodecConfig changes to the flagship, reversible)
RUNS = {"lossy": ({}, False),
        "subpixel2": ({"subpixel_accuracy": 2}, False),
        "lossless": ({"quantization_texture": 0}, True)}


def _flagship(**kw):
    from qsvc_tpu_torch.config import CodecConfig
    args = dict(pixels_in_x=1920, pixels_in_y=1088, TRLs=5, GOPs=4,
                SRLs=5, search_range=4, update_factor=0.25,
                quantization_texture=45000)
    args.update(kw)
    return CodecConfig(**args)


def _video(cfg):
    from qsvc_tpu_torch.io import synthetic_video
    return synthetic_video(cfg.pictures, cfg.pixels_in_y, cfg.pixels_in_x,
                           seed=0)


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _planes_sha(planes) -> list:
    return [_sha(p.cpu().numpy().tobytes()) for p in planes]


def _to_bytes(stream) -> bytes:
    from qsvc_tpu_torch.utils import trace
    with trace.stage("to_bytes"):
        return stream.to_bytes()


def _traced(fn, between=lambda: None):
    """``fn()`` once to warm up and, after ``between()``, once timed,
    under one run log (``qsvc_tpu_torch.utils.trace``) installed before
    the warm-up, so that its device anchor and the collector's hook are
    set up outside the timed call.  Returns the warm-up's result, the
    timed call's result, its wall seconds, the seconds of each stage it
    timed and its halo exchanges' totals."""
    from qsvc_tpu_torch.parallel import mesh as pmesh
    from qsvc_tpu_torch.utils import trace
    log = trace.RunLog()
    prev = trace.set_run_log(log)
    try:
        warm = fn()
        between()
        log.clear()
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        return (warm, out, seconds, log.summary(),
                pmesh.halo_totals(log.records))
    finally:
        trace.set_run_log(prev)


def _rank(rank, n, store):
    """One rank: the three runs' distributed encodes, and the lossless
    run's sharded synthesis and closed-GOP encode."""
    import torch
    from qsvc_tpu_torch.ops import cuda_lib
    from qsvc_tpu_torch.parallel import distributed as pdist
    from qsvc_tpu_torch.parallel import transform as ptransform
    dev = torch.device("cuda", rank)
    pdist.initialize(dev, init_method=f"file://{store}", world_size=n,
                     rank=rank)
    try:
        mesh = pdist.make_gop_mesh(dev)
        out = {}
        for name, (kw, reversible) in RUNS.items():
            cfg = _flagship(**kw)
            vid = _video(cfg)

            def encode():
                vs = pdist.compress_distributed(vid, cfg, mesh,
                                                reversible=reversible)
                torch.cuda.synchronize(dev)
                return _to_bytes(vs)
            def between():
                cuda_lib.reset_launches()
                torch.distributed.barrier(device_ids=[rank])
            torch.cuda.reset_peak_memory_stats(dev)
            warm, data, seconds, stages, halo = _traced(encode, between)
            res = {"sha": _sha(data), "bytes": len(data),
                   "warm_up_same": warm == data, "seconds": seconds,
                   "stages": stages, "launches": dict(cuda_lib.launches),
                   "halo_exchanges": halo["exchanges"],
                   "halo_bytes_sent": halo["sent"],
                   "halo_bytes_received": halo["received"],
                   "halo_seconds": halo["seconds"]}
            t0 = time.perf_counter()      # the sharded MCTF alone
            st = ptransform.analyze_sharded(
                *pdist.shard_video_gops(vid, cfg, mesh), cfg, mesh)
            torch.cuda.synchronize(dev)
            res["mctf_seconds"] = time.perf_counter() - t0
            res["peak_reserved_gib"] = (torch.cuda.max_memory_reserved(dev)
                                        / 2 ** 30)
            if reversible:
                res["synthesis_sha"] = _planes_sha(
                    ptransform.synthesize_sharded(st, cfg, mesh))
                res["gops_sha"] = [_sha(b) for b in
                                   pdist.encode_gops_distributed(
                                       vid, cfg, mesh, reversible=True)]
            out[name] = res
        pdist.end_group()
        return out
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _sequential(name, n, dev):
    """The sequential counterparts of one run on ``dev``."""
    import torch
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.mctf import transform
    kw, reversible = RUNS[name]
    cfg = _flagship(**kw)
    vid = _video(cfg)

    def encode():
        vs = api.compress(vid, cfg, reversible=reversible, device=dev)
        torch.cuda.synchronize(dev)
        return _to_bytes(vs)
    _, data, seconds, stages, _ = _traced(encode)
    out = {"sha": _sha(data), "bytes": len(data), "seconds": seconds,
           "stages": stages}
    if reversible:
        rec = transform.synthesize(transform.analyze(
            *(torch.from_numpy(p).to(dev) for p in vid.planes()), cfg), cfg)
        S = cfg.gop_size * cfg.GOPs // n
        out["synthesis_sha"] = [_planes_sha(p[r * S:(r + 1) * S + 1]
                                            for p in rec) for r in range(n)]
        out["gops_sha"] = [_sha(s.to_bytes()) for s in api.compress_gops(
            vid, cfg, reversible=True, device=dev)]
    return out


def check(n: int) -> dict:
    """The three runs on ``n`` ranks, one per card, against the
    sequential ones on ``cuda:0``: a dict with ``ok`` (every equality
    held), ``mismatches`` and the runs' numbers."""
    import torch
    from qsvc_tpu_torch.parallel import distributed as pdist
    from qsvc_tpu_torch.parallel.scaling import cards as card_names
    frames = _flagship().pictures
    t0 = time.perf_counter()
    ranks = pdist.run_ranks(_rank, n)
    ranks_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    bad = []
    runs = {}
    for name in RUNS:
        want = _sequential(name, n, dev)
        got = [r[name] for r in ranks]
        for r, res in enumerate(got):
            if res["sha"] != want["sha"] or not res["warm_up_same"]:
                bad.append(f"{name}: rank {r}'s compress_distributed != "
                           f"api.compress")
            if "synthesis_sha" in want:
                if res["synthesis_sha"] != want["synthesis_sha"][r]:
                    bad.append(f"{name}: rank {r}'s synthesize_sharded != "
                               f"transform.synthesize")
                if res["gops_sha"] != want["gops_sha"]:
                    bad.append(f"{name}: rank {r}'s encode_gops_distributed"
                               f" != api.compress_gops")
        seconds = max(res["seconds"] for res in got)
        runs[name] = {
            "bytes": want["bytes"], "sha256": want["sha"],
            "rank_seconds": [res["seconds"] for res in got],
            "sequential_seconds": want["seconds"],
            "distributed_fps": frames / seconds,
            "sequential_fps": frames / want["seconds"],
            "rank_stages": [res["stages"] for res in got],
            "sequential_stages": want["stages"],
            "rank_mctf_seconds": [res["mctf_seconds"] for res in got],
            "rank_peak_reserved_gib": [res["peak_reserved_gib"]
                                       for res in got],
            "rank_launches": [res["launches"] for res in got],
            "rank_halo_exchanges": [res["halo_exchanges"] for res in got],
            "rank_halo_bytes_sent": [res["halo_bytes_sent"] for res in got],
            "rank_halo_bytes_received": [res["halo_bytes_received"]
                                         for res in got],
            "rank_halo_seconds": [res["halo_seconds"] for res in got]}
    return {"cards": card_names(), "ranks": n, "frames": frames,
            "host_cores": os.cpu_count(),
            "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
            "spawn_to_end_seconds": ranks_s, "runs": runs,
            "mismatches": bad, "ok": not bad}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    cards = torch.cuda.device_count()
    n = args.ranks or cards
    if not torch.cuda.is_available() or n > cards:
        print(f"nccl_halo: {n} ranks need {n} cards, {cards} visible",
              file=sys.stderr)
        return 1
    from qsvc_tpu_torch.parallel import distributed as pdist
    result = check(n)
    result["scaling_flagship_gop"] = pdist.measure_scaling(
        n, cfg=_flagship(GOPs=1), device="cuda")
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if not result["ok"]:
        print(f"nccl_halo: {result['mismatches']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
