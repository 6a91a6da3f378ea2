"""Per-stage attribution of the flagship's staged decode, and its swing.

Port of the JAX package's ``tools/profile_decode5.py``: the flagship's 4
GOPs (``bench.flagship()``) are encoded, the decode's programs prewarmed
(``api.prewarm_decode`` with the streams' own ``cfg``, as the bench does)
and warmed up, then the bench's staged decode, a loop of ``api.expand(s,
to_host=False)`` over the 4 streams, runs ``--loops`` times in this one
process, each loop under a ``utils.trace.RunLog``.  Per loop: its wall
and the seconds of each stage that ``api.expand`` and
``frame_codec.decode_frames`` record (``decode.todo``, ``.native``,
``.pack``, ``.dispatch``, ``.idwt_dispatch``, ``.motion``,
``.synthesize_dispatch``, ``.wait_device``) and the rest of the loop that
no stage covers.  Over the loops: each one's median, (max - min) /
median and max - min in seconds; the stage whose seconds range widest
is the one that carries the loop's swing.  Then
``profile.device_profile`` runs over one more loop.

Run from the root of a checkout (one card; no CPU fallback):

    python3 -m qsvc_tpu_torch.tools.profile_decode [--loops N] [--out F]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Dict, List

import torch

from .. import api
from ..config import CodecConfig
from ..io import Video
from ..utils import trace
from . import bench
from .profile import device_profile, needs_card, print_profile, write_json

#: the label of a loop's seconds that no stage covers
OUTSIDE = "(outside stages)"


def spread(values: List[float]) -> dict:
    """Median, min, max, max - min and (max - min) / median of
    ``values`` (the last None at a zero median)."""
    med = statistics.median(values)
    lo, hi = min(values), max(values)
    return {"median": med, "min": lo, "max": hi, "range": hi - lo,
            "spread": (hi - lo) / med if med else None}


def loop_stats(loops: List[dict]) -> dict:
    """Statistics over ``loops`` ({"wall_s", "stages": {stage: s}}): the
    wall's, each stage's (a stage missing from a loop counts 0 there)
    and those of the seconds outside every stage; ``swing`` names the
    stage (or :data:`OUTSIDE`) whose seconds range widest."""
    names = sorted({k for lp in loops for k in lp["stages"]})
    stages: Dict[str, dict] = {
        k: spread([lp["stages"].get(k, 0.0) for lp in loops]) for k in names}
    stages[OUTSIDE] = spread([lp["wall_s"] - sum(lp["stages"].values())
                              for lp in loops])
    return {"loops": len(loops),
            "wall": spread([lp["wall_s"] for lp in loops]),
            "stages": stages,
            "swing": max(stages, key=lambda k: stages[k]["range"])}


def profile_decode(cfg: CodecConfig, video: Video, device="cuda",
                   loops: int = 20) -> dict:
    """The staged decode of ``video``'s GOPs at ``cfg``, ``loops`` times
    with the stage split of each; on a card also the profile of one more
    loop.  Returns the JSON row."""
    streams = api.compress_gops(video, cfg, reversible=False, device=device)
    api.prewarm_decode(streams[0].cfg, reversible=False,
                       delta=streams[0].delta or None, device=device)

    def loop():
        for s in streams:
            api.expand(s, to_host=False, device=device)
    loop()                                              # warm-up
    per_loop = []
    for _ in range(loops):
        log = trace.RunLog()
        prev = trace.set_run_log(log)
        try:
            t0 = time.perf_counter()
            loop()
            wall = time.perf_counter() - t0
        finally:
            trace.set_run_log(prev)
        per_loop.append({
            "wall_s": wall, "fps": video.frames / wall,
            "stages": log.summary(),
            "blocks": sum(r.get("blocks", 0) for r in log.records)})
    row = {"device": bench.device_name(device), "frames": video.frames,
           "gops": len(streams), "per_loop": per_loop,
           "stats": loop_stats(per_loop), "profile": None}
    if torch.device(device).type == "cuda":
        row["profile"] = device_profile(loop)
    return row


def print_decode(row: dict) -> None:
    """Each stage's median and spread over the loops, the swing's stage,
    then the profile."""
    st = row["stats"]
    w = st["wall"]
    print(f"profile_decode [{row['device']}]: {row['gops']} GOPs, "
          f"{row['frames']} frames, {st['loops']} loops; loop wall median "
          f"{w['median']:.6f} s ({row['frames'] / w['median']:.3f} fps), "
          f"min {w['min']:.6f}, max {w['max']:.6f}, (max - min) / median "
          f"{w['spread']:.4f}", flush=True)
    for name, s in sorted(st["stages"].items(),
                          key=lambda kv: -kv[1]["median"]):
        sp = "n/a" if s["spread"] is None else f"{s['spread']:.4f}"
        print(f"  {name:28s} median {s['median']:.6f} s, min {s['min']:.6f}"
              f", max {s['max']:.6f}, max - min {s['range']:.6f} s, "
              f"(max - min) / median {sp}", flush=True)
    print(f"  the swing's stage (widest max - min): {st['swing']}",
          flush=True)
    if row["profile"] is not None:
        print_profile("device profile of one staged decode loop",
                      row["profile"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loops", type=int, default=20,
                    help="4-GOP decode loops to time (default 20)")
    ap.add_argument("--out", default="", help="also write the row here")
    args = ap.parse_args(argv)
    if not needs_card("profile_decode"):
        return 1
    cfg, video = bench.flagship()
    row = profile_decode(cfg, video, device="cuda", loops=args.loops)
    print_decode(row)
    write_json(args.out, row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
