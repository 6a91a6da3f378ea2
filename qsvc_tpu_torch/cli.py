"""Command-line interface: ``python -m qsvc_tpu_torch.cli <command> ...``.

Port of ``qsvc_tpu/cli.py``, with the same commands and flags.  It
mirrors the reference's ``mctf compress | expand | transcode | info |
psnr`` vocabulary (``mctf.sh`` dispatcher + ``MCTF_parser.py`` flags)
with the same canonical parameter names.  The commands that reach the
device (compress, expand, rd, search_slope) take ``--device`` (default
``cuda``); without a CUDA device ``--device cuda`` raises, and
``--device cpu`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .config import CodecConfig
from .io import yuv


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--trace", default="",
                   help="append per-stage JSONL timing records to this "
                        "file (the reference's ./trace analogue)")
    p.add_argument("--pixels_in_x", type=int, default=352)
    p.add_argument("--pixels_in_y", type=int, default=288)
    p.add_argument("--TRLs", type=int, default=4)
    p.add_argument("--SRLs", type=int, default=5)
    p.add_argument("--GOPs", type=int, default=1)
    p.add_argument("--block_size", type=int, default=0)
    p.add_argument("--block_size_min", type=int, default=0)
    p.add_argument("--search_range", type=int, default=4)
    p.add_argument("--subpixel_accuracy", type=int, default=0)
    p.add_argument("--update_factor", type=float, default=0.25)
    p.add_argument("--always_B", type=int, default=0)
    p.add_argument("--quantization_texture", type=float, default=45000)
    p.add_argument("--quantization_step", type=float, default=0)
    p.add_argument("--nLayers", type=int, default=5)
    p.add_argument("--FPS", type=float, default=30.0)
    p.add_argument("--texture_coder", default="bp", choices=["bp", "mq"],
                   help="entropy coder: bp (bit-parallel, fast) or mq "
                        "(spec-style MQ, maximum compaction)")
    p.add_argument("--texture_backend", default="internal",
                   help="texture codec backend: internal (full "
                        "scalability) or cp | zlib | j2k | mj2k "
                        "(codec/backends.py registry — the reference's "
                        "mcj2k/mcmj2k/mccp codec profiles)")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device the transforms run on (cuda, "
                        "cuda:N or cpu); cuda never falls back to the CPU")


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device "
                           f"(pass --device cpu to run on the CPU)")
    return dev


def _read_streams(path: str):
    """Read a .qsvc file: either one whole-sequence stream or the
    streaming per-GOP container.  Returns a list of VideoStream."""
    from .codec import codestream
    from .codec.codestream import VideoStream
    with open(path, "rb") as f:
        data = f.read()
    if codestream.is_gop_container(data):
        return [VideoStream.from_bytes(b)
                for b in codestream.unpack_gop_streams(data)]
    return [VideoStream.from_bytes(data)]


def _cfg(args) -> CodecConfig:
    return CodecConfig(
        pixels_in_x=args.pixels_in_x, pixels_in_y=args.pixels_in_y,
        TRLs=args.TRLs, SRLs=args.SRLs, GOPs=args.GOPs,
        block_size=args.block_size, block_size_min=args.block_size_min,
        search_range=args.search_range,
        subpixel_accuracy=args.subpixel_accuracy,
        update_factor=args.update_factor, always_B=bool(args.always_B),
        quantization_texture=args.quantization_texture,
        quantization_step=args.quantization_step, nLayers=args.nLayers,
        FPS=args.FPS, texture_coder=args.texture_coder,
        texture_backend=args.texture_backend)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qsvc-torch",
                                 description="scalable video codec "
                                             "(PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("compress", help="encode a raw YUV420 video")
    _add_common(pc)
    _add_device(pc)
    pc.add_argument("--input", required=True, help="raw .yuv (I420) file")
    pc.add_argument("--output", required=True, help="output .qsvc stream")
    pc.add_argument("--lossless", action="store_true",
                    help="reversible 5/3 path, no truncation")
    pc.add_argument("--pictures", type=int, default=0,
                    help="frames to read (default: GOPs*gop_size+1; any "
                         "count works — the tail GOP is padded and the "
                         "true count is recorded in the stream)")
    pc.add_argument("--window", type=int, default=2,
                    help="GOPs in flight in the streaming pipeline")
    pc.add_argument("--resume", default="",
                    help="checkpoint/resume directory: already-encoded "
                         "GOPs (same frames + params) are reused, so a "
                         "killed encode restarts where it stopped "
                         "(motion_estimate.cpp:659-682 resume semantics)")
    pc.add_argument("--whole_sequence", action="store_true",
                    help="single open-GOP stream in one encode "
                         "(the non-streaming research path; default is "
                         "the bounded-memory per-GOP streaming container)")

    pe = sub.add_parser("expand", help="decode a .qsvc stream")
    pe.add_argument("--input", required=True)
    pe.add_argument("--output", required=True)
    pe.add_argument("--quantization", type=float, default=0,
                    help="decode-time slope threshold (QS extraction)")
    pe.add_argument("--discard_TRLs", type=int, default=0,
                    help="drop finest temporal levels (TS extraction)")
    _add_device(pe)

    pt = sub.add_parser("transcode", help="extract a reduced stream")
    pt.add_argument("--input", required=True)
    pt.add_argument("--output", required=True)
    pt.add_argument("--quantization", type=float, default=0)
    pt.add_argument("--clayers", type=int, default=0,
                    help="keep only the first N quality layers")
    pt.add_argument("--discard_TRLs", type=int, default=0)
    pt.add_argument("--discard_SRLs", type=int, default=0)
    pt.add_argument("--algorithm", default="PTS",
                    choices=["PTS", "ITS", "PTL", "AmPTL", "FS", "SR",
                             "ISR"],
                    help="layer-ordering / BRC policy (FS/SR/ISR are the "
                         "reference's per-GOP R-D searches, here driven by "
                         "recorded slopes instead of decode probes)")
    pt.add_argument("--BRC", type=float, default=0,
                    help="target kbps for rate-controlled extraction")
    pt.add_argument("--FPS", type=float, default=30.0)

    pi = sub.add_parser("info", help="bitrate accounting of a stream")
    pi.add_argument("--input", required=True)
    pi.add_argument("--FPS", type=float, default=30.0)

    pp = sub.add_parser("psnr", help="PSNR between two raw videos")
    pp.add_argument("--file_A", required=True)
    pp.add_argument("--file_B", required=True)
    pp.add_argument("--pixels_in_x", type=int, required=True)
    pp.add_argument("--pixels_in_y", type=int, required=True)

    pr = sub.add_parser("rd", help="trace an RD curve from one stream "
                                   "(psnr_vs_br equivalent, no re-encode)")
    pr.add_argument("--input", required=True, help=".qsvc stream")
    pr.add_argument("--original", required=True, help="raw .yuv source")
    pr.add_argument("--quantizations", default="43000,44000,45000,46000",
                    help="comma-separated slope sweep")
    pr.add_argument("--FPS", type=float, default=30.0)
    _add_device(pr)

    ps = sub.add_parser("search_slope",
                        help="find the slope hitting an RMSE target "
                             "(searchSlope_byDistortion equivalent)")
    ps.add_argument("--input", required=True)
    ps.add_argument("--original", required=True)
    ps.add_argument("--distortion", type=float, required=True,
                    help="target RMSE (Y)")
    _add_device(ps)

    pv = sub.add_parser("vix2raw", help="strip a VIX header (vix2raw.c)")
    pv.add_argument("--input", required=True)
    pv.add_argument("--output", required=True)

    pj = sub.add_parser("export_j2k",
                        help="export one frame's Y/U/V planes as standard "
                             "JPEG 2000 code-streams — lossless 5/3 by "
                             "default, lossy 9/7 multi-layer with "
                             "--irreversible/--layer_slopes (any "
                             "conformant decoder reads them; the "
                             "reference's per-component .j2c layout)")
    pj.add_argument("--input", required=True, help="raw .yuv (I420) file")
    pj.add_argument("--output", required=True,
                    help="output prefix: writes <prefix>_{Y,U,V}.j2c")
    pj.add_argument("--pixels_in_x", type=int, required=True)
    pj.add_argument("--pixels_in_y", type=int, required=True)
    pj.add_argument("--frame", type=int, default=0)
    pj.add_argument("--SRLs", type=int, default=5)
    pj.add_argument("--codeblock_size", type=int, default=64)
    pj.add_argument("--irreversible", action="store_true",
                    help="lossy 9/7 + QCD quantization (Creversible=no)")
    pj.add_argument("--base_delta", type=float, default=1.0 / 32,
                    help="base quantization step for --irreversible")
    pj.add_argument("--layer_slopes", default="",
                    help="comma-separated quality-layer slopes "
                         "(Kakadu-style units, e.g. 46000,45000,44000)")

    args = ap.parse_args(argv)

    if args.cmd == "compress":
        from . import api
        from .codec import codestream
        dev = _device(args)
        if args.trace:
            from .utils import trace as _tr
            _tr.set_run_log(_tr.RunLog(path=args.trace))
        cfg = _cfg(args)
        n = args.pictures or cfg.pictures
        vid = yuv.read_yuv(args.input, cfg.pixels_in_x, cfg.pixels_in_y, n)
        if vid.frames < n:
            print(f"warning: only {vid.frames} frames available",
                  file=sys.stderr)
        if args.lossless:
            cfg = cfg.replace(quantization_texture=0)
        t0 = time.time()
        if args.whole_sequence:
            data = api.compress(vid, cfg, reversible=args.lossless,
                                device=dev).to_bytes()
            with open(args.output, "wb") as f:
                f.write(data)
        else:
            # streaming path: bounded memory (window GOPs in flight),
            # append-only output, optional checkpoint/resume store
            S = cfg.gop_size
            G = (max(1, -(-(vid.frames - 1) // S)) if cfg.TRLs > 1
                 else cfg.GOPs)
            if G >= 2:
                # capture the GOP's device programs before the first GOP
                api.prewarm(cfg, reversible=args.lossless, device=dev)

            def report(g, nbytes, cached):
                el = time.time() - t0
                print(f"GOP {g + 1}/{G}: {nbytes} bytes"
                      f"{' (cached)' if cached else ''}  [{el:.1f}s]",
                      file=sys.stderr, flush=True)

            if args.resume:
                from .utils.artifacts import (ArtifactStore,
                                              compress_gops_resumable)
                blobs = compress_gops_resumable(
                    vid, cfg, ArtifactStore(args.resume),
                    reversible=args.lossless, window=args.window,
                    progress=report, device=dev)
                with open(args.output, "wb") as f:
                    f.write(codestream.pack_gop_streams(blobs))
            else:
                with open(args.output, "wb") as f:
                    f.write(codestream.GOP_MAGIC)

                    def write_one(i, vs):
                        b = vs.to_bytes()
                        buf = bytearray()
                        codestream._wvarint(buf, len(b))
                        f.write(bytes(buf) + b)
                        f.flush()
                        report(i, len(b), False)

                    gop_cfg = cfg.replace(GOPs=1)
                    chunks = (vid[g * S:(g + 1) * S + 1]
                              for g in range(G))
                    api.compress_chunks(chunks, gop_cfg,
                                        reversible=args.lossless,
                                        window=args.window,
                                        progress=write_one, device=dev)
        dt = time.time() - t0
        raw = vid.y.size * 3 // 2
        import os
        total = os.path.getsize(args.output)
        print(f"{vid.frames} frames -> {total} bytes "
              f"({total*8/raw:.3f} bpp) in {dt:.2f}s "
              f"({vid.frames/dt:.2f} fps)")
        return 0

    if args.cmd == "expand":
        from .api import expand, expand_gops, prewarm_decode
        from .codec.frame_codec import slope_to_threshold
        dev = _device(args)
        streams = _read_streams(args.input)
        thr = slope_to_threshold(args.quantization) if args.quantization else 0.0
        t0 = time.time()
        if (len(streams) > 1 and not args.discard_TRLs
                and streams[0].cfg.texture_backend == "internal"):
            # capture the decode's programs before the first GOP
            prewarm_decode(streams[0].cfg,
                           reversible=streams[0].reversible,
                           delta=streams[0].delta or None, device=dev)
        if len(streams) > 1:
            vid = expand_gops(streams, threshold=thr,
                              discard_TRLs=args.discard_TRLs, device=dev)
        else:
            vid = expand(streams[0], threshold=thr,
                         discard_TRLs=args.discard_TRLs, device=dev)
        dt = time.time() - t0
        yuv.write_yuv(args.output, vid)
        print(f"{vid.frames} frames ({vid.width}x{vid.height}) in {dt:.2f}s "
              f"({vid.frames/dt:.2f} fps)")
        return 0

    if args.cmd == "transcode":
        from .scal import extract
        from .codec import codestream
        streams = _read_streams(args.input)
        outs = [extract.transcode(
            vs, quantization=args.quantization, clayers=args.clayers,
            discard_TRLs=args.discard_TRLs, discard_SRLs=args.discard_SRLs,
            algorithm=args.algorithm, BRC=args.BRC, fps=args.FPS)
            for vs in streams]
        if len(outs) > 1:
            data = codestream.pack_gop_streams([o.to_bytes()
                                                for o in outs])
        else:
            data = outs[0].to_bytes()
        with open(args.output, "wb") as f:
            f.write(data)
        print(f"extracted {len(data)} bytes")
        return 0

    if args.cmd == "info":
        from .scal.info import format_table, stream_info
        streams = _read_streams(args.input)
        total = 0
        for g, vs in enumerate(streams):
            if len(streams) > 1:
                print(f"--- GOP {g} ---")
            si = stream_info(vs, args.FPS)
            total += si.total_bytes
            print(format_table(si))
        if len(streams) > 1:
            print(f"total {total} bytes")
        return 0

    if args.cmd == "psnr":
        a = yuv.read_yuv(args.file_A, args.pixels_in_x, args.pixels_in_y)
        b = yuv.read_yuv(args.file_B, args.pixels_in_x, args.pixels_in_y)
        n = min(a.frames, b.frames)
        py, pu, pv = yuv.video_psnr(a[:n], b[:n])
        print(f"Y {py:.3f} dB  U {pu:.3f} dB  V {pv:.3f} dB")
        return 0

    if args.cmd in ("rd", "search_slope"):
        from .scal import rd as rdmod
        dev = _device(args)
        streams = _read_streams(args.input)
        cfg = streams[0].cfg
        tw, th = streams[0].true_dims or (cfg.pixels_in_x, cfg.pixels_in_y)
        nframes = sum((s.true_frames or s.cfg.pictures) - 1
                      for s in streams) + 1
        orig = yuv.read_yuv(args.original, tw, th, nframes)
        if args.cmd == "rd":
            qs = [float(q) for q in args.quantizations.split(",")]
            if len(streams) > 1:
                pts = rdmod.rd_curve_gops(streams, orig, qs, fps=args.FPS,
                                          device=dev)
            else:
                pts = rdmod.rd_curve(streams[0], orig, qs, fps=args.FPS,
                                     device=dev)
            print(rdmod.format_curve(pts))
        else:
            if len(streams) > 1:
                print("search_slope needs a whole-sequence stream "
                      "(compress --whole_sequence)", file=sys.stderr)
                return 1
            q, pt = rdmod.search_slope_for_distortion(streams[0], orig,
                                                      args.distortion,
                                                      device=dev)
            print(f"slope {q:.1f}: {pt.kbps:.1f} kbps, RMSE {pt.rmse_y:.3f},"
                  f" PSNR {pt.psnr_y:.2f} dB")
        return 0

    if args.cmd == "export_j2k":
        from .codec import j2k
        vid = yuv.read_yuv(args.input, args.pixels_in_x, args.pixels_in_y,
                           args.frame + 1)
        total = 0
        slopes = ([float(s) for s in args.layer_slopes.split(",")]
                  if args.layer_slopes else None)
        for comp, plane in (("Y", vid.y), ("U", vid.u), ("V", vid.v)):
            data = j2k.encode_j2c(np.asarray(plane[args.frame], np.uint8),
                                  levels=args.SRLs - 1,
                                  cb=args.codeblock_size,
                                  reversible=not args.irreversible,
                                  base_delta=args.base_delta,
                                  layer_slopes=slopes)
            path = f"{args.output}_{comp}.j2c"
            with open(path, "wb") as f:
                f.write(data)
            total += len(data)
            print(f"{path}: {len(data)} bytes")
        print(f"total {total} bytes")
        return 0

    if args.cmd == "vix2raw":
        n = yuv.vix_to_raw(args.input, args.output)
        print(f"{n} payload bytes")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
