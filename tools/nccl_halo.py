"""The port's sharded flagship encode across cards over nccl, one rank per
card, against the sequential encode on one card.

    python3 tools/nccl_halo.py [--ranks N] [--out FILE]

Spawns N ranks (default: every visible card), rank r on ``cuda:r``,
joined by ``nccl`` (``qsvc_tpu_torch.parallel.distributed.run_ranks``).
Every rank runs ``compress_distributed`` of the flagship, 1920x1088,
TRLs 5, 4 GOPs, 9/7 at slope 45000, update 1/4, its GOPs split over the
ranks, once to warm up and once timed, and returns its stream bytes,
seconds and kernel launches.  This process then encodes the same video
with ``api.compress`` on ``cuda:0`` (warm-up and timed) and checks that
every rank's bytes equal it.  Prints one JSON object, with the cards'
names and power limits as ``nvidia-smi`` reads them, and writes it to
FILE with ``--out``.  Exits 1 on a mismatch or without N cards.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _flagship():
    from qsvc_tpu_torch.config import CodecConfig
    from qsvc_tpu_torch.io import synthetic_video
    cfg = CodecConfig(pixels_in_x=1920, pixels_in_y=1088, TRLs=5, GOPs=4,
                      SRLs=5, search_range=4, update_factor=0.25,
                      quantization_texture=45000)
    return cfg, synthetic_video(cfg.pictures, 1088, 1920, seed=0)


def _rank(rank, n, store):
    """One rank: the distributed encode, warm-up then timed."""
    import torch
    from qsvc_tpu_torch.ops import cuda_lib
    from qsvc_tpu_torch.parallel import distributed as pdist
    dev = torch.device("cuda", rank)
    pdist.initialize(dev, init_method=f"file://{store}", world_size=n,
                     rank=rank)
    try:
        mesh = pdist.make_gop_mesh(dev)
        cfg, vid = _flagship()

        def encode():
            out = pdist.compress_distributed(
                vid, cfg, mesh, reversible=False).to_bytes()
            torch.cuda.synchronize(dev)
            return out
        cuda_lib.reset_launches()
        encode()
        launches = dict(cuda_lib.launches)
        torch.distributed.barrier()
        t0 = time.perf_counter()
        data = encode()
        seconds = time.perf_counter() - t0
        torch.distributed.barrier()   # no rank leaves while a peer sends
        return {"bytes": data, "seconds": seconds, "launches": launches}
    finally:
        torch.distributed.destroy_process_group()


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
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.parallel import distributed as pdist
    from qsvc_tpu_torch.parallel.scaling import cards as card_names
    t0 = time.perf_counter()
    ranks = pdist.run_ranks(_rank, n)
    ranks_s = time.perf_counter() - t0
    cfg, vid = _flagship()
    dev = torch.device("cuda", 0)
    api.compress(vid, cfg, reversible=False, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    want = api.compress(vid, cfg, reversible=False,
                        device=dev).to_bytes()
    seq_s = time.perf_counter() - t0
    same = [r["bytes"] == want for r in ranks]
    result = {
        "cards": card_names(),
        "ranks": n, "frames": vid.frames, "bytes": len(want),
        "identical_to_api_compress": same,
        "rank_seconds": [r["seconds"] for r in ranks],
        "sequential_seconds": seq_s,
        "distributed_fps": vid.frames / max(r["seconds"] for r in ranks),
        "sequential_fps": vid.frames / seq_s,
        "rank_launches": [r["launches"] for r in ranks],
        "spawn_to_end_seconds": ranks_s,
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if not all(same):
        print("nccl_halo: a rank's stream differs from api.compress",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
