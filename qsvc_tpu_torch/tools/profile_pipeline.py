"""GOP-level attribution of the staged (device-resident) encode.

Port of the JAX package's ``tools/profile_round3.py``: the production
path timed at GOP granularity, on the flagship's GOPs staged on the card
(``bench.flagship()``; the JAX tool's 3 GOPs are the bench's 4 here):

- (a) one GOP's ``api.compress_dispatch`` + ``compress_finish`` alone;
- (b) ``transform.analyze_jit`` alone, then one fetch of a scalar;
- (b2) one GOP's dispatch (the host's time to queue it) and then its
  finish;
- (c) all GOPs pipelined through ``api.compress_chunks``: the bench's
  ``value`` window.

Each timing ends when the host holds the result (the fetches and the
native coding wait for the card; (b) synchronises).  The streams of
(a), (b2) and (c) are kept for comparison with ``api.compress``.

Run from the root of a checkout (one card; no CPU fallback):

    python3 -m qsvc_tpu_torch.tools.profile_pipeline [--out F]
"""

from __future__ import annotations

import argparse
import sys
import time

from .. import api
from ..config import CodecConfig
from ..io import Video
from ..mctf import transform
from . import bench
from .profile import needs_card, write_json


def profile_pipeline(cfg: CodecConfig, video: Video, device="cuda",
                     reps: int = 3) -> tuple:
    """(a)-(c) of the module docstring for ``video``'s GOPs at ``cfg``,
    ``reps`` times each ((c) twice).  Returns (row, streams): the JSON
    row and the bytes of (a)'s GOP 0, (b2)'s GOP and (c)'s GOPs."""
    G = cfg.GOPs
    gop_cfg = cfg.replace(GOPs=1)
    staged = bench.staged_gops(video, cfg, device)

    def one_gop(chunk):
        return api.compress_finish(api.compress_dispatch(
            chunk, gop_cfg, reversible=False, device=device))

    t0 = time.perf_counter()
    one_gop(staged[0])
    row = {"device": bench.device_name(device), "gops": G,
           "frames": video.frames, "warmup_s": time.perf_counter() - t0}
    streams = {}

    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        vs = one_gop(staged[0])
        seconds.append(time.perf_counter() - t0)
    row["one_gop_s"] = seconds
    streams["one_gop"] = vs.to_bytes()

    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        st = transform.analyze_jit(staged[0].y, staged[0].u, staged[0].v,
                                   gop_cfg)
        st.low_y.reshape(-1)[:1].cpu()
        seconds.append(time.perf_counter() - t0)
    row["analyze_fetch1_s"] = seconds

    g = min(1, G - 1)
    t0 = time.perf_counter()
    pending = api.compress_dispatch(staged[g], gop_cfg, reversible=False,
                                    device=device)
    row["dispatch_host_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    streams["dispatch_finish"] = api.compress_finish(pending).to_bytes()
    row["finish_after_dispatch_s"] = time.perf_counter() - t0
    row["dispatch_finish_gop"] = g

    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = api.compress_chunks(staged, gop_cfg, reversible=False,
                                  device=device)
        seconds.append(time.perf_counter() - t0)
    row["pipelined_s"] = seconds
    row["pipelined_fps"] = [video.frames / s for s in seconds]
    streams["pipelined"] = [vs.to_bytes() for vs in out]
    return row, streams


def print_pipeline(row: dict) -> None:
    print(f"profile_pipeline [{row['device']}]: {row['gops']} GOPs staged "
          f"on the device; warm-up (1 GOP) {row['warmup_s']:.6f} s",
          flush=True)
    for s in row["one_gop_s"]:
        print(f"(a) one-GOP dispatch+finish: {s:.6f} s", flush=True)
    for s in row["analyze_fetch1_s"]:
        print(f"(b) analyze_jit + fetch of one scalar: {s:.6f} s", flush=True)
    print(f"(b2) dispatch host time: {row['dispatch_host_s']:.6f} s; "
          f"finish after dispatch: {row['finish_after_dispatch_s']:.6f} s",
          flush=True)
    for s, fps in zip(row["pipelined_s"], row["pipelined_fps"]):
        print(f"(c) {row['gops']}-GOP pipelined compress_chunks: {s:.6f} s "
              f"= {fps:.3f} fps", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the row here")
    args = ap.parse_args(argv)
    if not needs_card("profile_pipeline"):
        return 1
    cfg, video = bench.flagship()
    row, _ = profile_pipeline(cfg, video, device="cuda")
    print_pipeline(row)
    write_json(args.out, row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
