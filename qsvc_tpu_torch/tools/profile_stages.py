"""Per-stage wall-clock attribution of the flagship's 1080p encode.

Port of the JAX package's ``tools/profile_stages.py``: one GOP of the
flagship (``bench.flagship()``: 1920x1088, TRLs 5, SRLs 5, search 4,
update 1/4, 9/7 at slope 45000, bp coder, ``synthetic_video(..., seed=0)``)
encoded twice by ``api.compress`` after a warm-up, the last rep read, in
the JAX tool's stages and order: upload, ``analyze_jit``,
DWT+quant+tile, the bp R-D simulation, select (compaction), the stats
and motion-residue fetch with the host selection, the fetch of the
compact tiles, ``decorrelate_jit``, native bp encode, total and fps.

Every stage ends in ``torch.cuda.synchronize()``, the counterpart of the
JAX tool's scalar fetch.  The stages are the production code's: the run
is ``api.compress`` itself, with its device programs wrapped (module
attributes swapped inside this tool) so that each ends in a synchronise
and records a ``utils.trace`` stage; the fetches and the native coding
are ``api.compress_finish``'s own stages.  The port fuses DWT+quant+tile,
the R-D simulation and the compaction into one captured program
(``frame_codec._encode_device_jit``), so there are two reps of each
kind:

- ``graphed``: the program replayed from its CUDA graph, timed whole;
- ``split``: its three eager parts, each timed (the functions the graph
  was captured from).

Both encodes must give ``api.compress``'s bytes (``identical``).  Then
``profile.device_profile`` runs over the graphed 4-GOP
``api.compress_chunks`` of the staged GOPs: the bench's ``value`` window.

Run from the root of a checkout (one card; no CPU fallback):

    python3 -m qsvc_tpu_torch.tools.profile_stages [--out F]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .. import api
from ..codec import bp_device, frame_codec
from ..config import CodecConfig
from ..io import Video
from ..mctf import motion_coding, transform
from ..utils import trace
from . import bench
from .profile import (device_profile, needs_card, print_profile, swapped,
                      sync, synced, write_json)

#: the rows printed, in the JAX tool's order: (label, trace stage)
ROWS = (("upload uint8", "upload"),
        ("MCTF analyze_jit (device)", "analyze_jit"),
        ("DWT+quant+tile (device, eager)", "dwt_quant_tile"),
        ("bp R-D sim (device, eager)", "bp_rd_sim"),
        ("select: compaction (device, eager)", "compact"),
        ("_encode_device_jit (device, graphed)", "encode_device_jit"),
        ("motion decorrelate_jit (device)", "decorrelate_jit"),
        ("stats+residue fetch, host select", "device_encode+stats_fetch"),
        ("fetch compact tiles", "select+gather_fetch"),
        ("native bp encode (host)", "native_entropy_coding"))


def _split_encode_device(device):
    """``frame_codec._encode_device`` in its three parts, each a synced
    stage (the same calls, in the same order)."""
    def run(planes, delta, th, tw, ms, levels, reversible, cb):
        with trace.stage("dwt_quant_tile"):
            tiles, maxabs, ovf = frame_codec._dwt_quant_tiles(
                planes, levels, reversible, delta, cb)
            sync(device)
        N, nb = tiles.shape[0], tiles.shape[1]
        with trace.stage("bp_rd_sim"):
            smax, _d0 = bp_device.bp_max_slope(
                tiles.reshape(N * nb, cb, cb), th, tw)
            sync(device)
        with trace.stage("compact"):
            compact, keep = frame_codec._compact_tiles(
                tiles, maxabs, smax.reshape(N, nb), ms)
            sync(device)
        return compact, maxabs, keep, ovf
    return run


def encode_stages(video: Video, cfg: CodecConfig, device, split: bool
                  ) -> tuple:
    """One ``api.compress`` of ``video`` with every device stage synced
    and recorded; ``split`` runs the fused texture program's eager parts.
    Returns (stream bytes, {stage: seconds}, total seconds)."""
    encode_device = (_split_encode_device(device) if split else
                     synced("encode_device_jit",
                            frame_codec._encode_device_jit, device))
    upload = api._upload

    def synced_upload(*args):          # the API's "upload" stage times it
        out = upload(*args)
        sync(device)
        return out
    swaps = [(api, "_upload", synced_upload),
             (transform, "analyze_jit",
              synced("analyze_jit", transform.analyze_jit, device)),
             (frame_codec, "_encode_device_jit", encode_device),
             (motion_coding, "decorrelate_jit",
              synced("decorrelate_jit", motion_coding.decorrelate_jit,
                     device))]
    log = trace.RunLog()
    prev = trace.set_run_log(log)
    try:
        with swapped(swaps):
            sync(device)
            t0 = time.perf_counter()
            vs = api.compress(video, cfg, reversible=False, device=device)
            total = time.perf_counter() - t0
    finally:
        trace.set_run_log(prev)
    return vs.to_bytes(), log.summary(), total


def profile_stages(cfg: CodecConfig, video: Video, device="cuda",
                   reps: int = 2) -> tuple:
    """The stage split of the first GOP of ``video`` (numpy planes) at
    ``cfg``, graphed and split, ``reps`` each (the last kept), beside
    ``api.compress``'s bytes; on a card also the profile of the graphed
    ``compress_chunks`` of all ``cfg.GOPs`` GOPs.  Returns (row, streams):
    the JSON row and the bytes of each kind's last encode."""
    S = cfg.gop_size
    gop_cfg = cfg.replace(GOPs=1)
    gop = video[0:S + 1]
    api.prewarm(gop_cfg, reversible=False, device=device)
    want = api.compress(gop, gop_cfg, reversible=False,
                        device=device).to_bytes()
    row = {"device": bench.device_name(device), "frames": gop.frames,
           "gops": cfg.GOPs, "bytes": len(want)}
    streams = {}
    for kind in ("graphed", "split"):
        for _ in range(reps):
            data, stages, total = encode_stages(gop, gop_cfg, device,
                                                kind == "split")
        streams[kind] = data
        row[kind] = {"stages": stages, "total_s": total,
                     "fps": gop.frames / total}
    row["identical"] = all(d == want for d in streams.values())
    row["profile"] = None
    if torch.device(device).type == "cuda":
        staged = bench.staged_gops(video, cfg, device)

        def chunks():
            api.compress_chunks(staged, gop_cfg, reversible=False,
                                device=device)
        chunks()                                        # warm-up
        row["profile"] = device_profile(chunks)
    return row, streams


def print_stages(row: dict) -> None:
    """The JAX tool's table for the graphed and the split rep, then the
    profile."""
    print(f"profile_stages [{row['device']}]: one GOP, {row['frames']} "
          f"frames, {row['bytes']} bytes; streams == api.compress: "
          f"{row['identical']}", flush=True)
    for kind in ("graphed", "split"):
        rep = row[kind]
        print(f"--- {kind} (last of the reps)", flush=True)
        listed = 0.0
        for label, name in ROWS:
            if name in rep["stages"]:
                listed += rep["stages"][name]
                print(f"{label:46s} {rep['stages'][name]:9.6f} s",
                      flush=True)
        rest = rep["total_s"] - listed
        print(f"{'rest (host: tiling, motion coding, container)':46s} "
              f"{rest:9.6f} s", flush=True)
        print(f"{'TOTAL':46s} {rep['total_s']:9.6f} s = "
              f"{rep['fps']:.3f} fps", flush=True)
    if row["profile"] is not None:
        print_profile("device profile of the graphed 4-GOP compress_chunks "
                      "(the bench's value window)", row["profile"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the row here")
    args = ap.parse_args(argv)
    if not needs_card("profile_stages"):
        return 1
    cfg, video = bench.flagship()
    row, _ = profile_stages(cfg, video, device="cuda")
    print_stages(row)
    write_json(args.out, row)
    return 0 if row["identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
