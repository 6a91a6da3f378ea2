"""Top-level codec API: compress / expand on a torch device.

Port of ``qsvc_tpu/api.py``.  Every entry point takes the JAX function's
arguments and a keyword-only ``device``, the card (``"cuda"``) unless
the caller asks for the CPU: numpy frames on the card run the MCTF and
texture transforms through the kernels of ``csrc/``, ``device="cpu"``
runs their plain PyTorch versions; there is no fallback from one to the
other.  Where the JAX package runs a jitted program, the
port runs its captured counterpart (``transform.analyze_jit`` /
``synthesize_jit``, ``motion_coding.decorrelate_jit`` /
``correlate_jit``, the texture stages of ``frame_codec``): a CUDA graph
per shape on the card, the eager functions on the CPU, and
:func:`prewarm` / :func:`prewarm_decode` capture them ahead of a
configuration's first GOP, as the JAX ones compile.  Frames already
on the device (the staged mode) are used in place.  EBCOT
entropy coding runs on the host in the native coder; the streams are
byte-identical to the JAX package's wherever the arithmetic is integer.
A ``cfg.texture_backend`` other than "internal" codes every subband
plane with a per-plane codec of :mod:`.codec.backends` instead; the MCTF
still runs on ``device``.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .codec import backends, codestream, fast, frame_codec
from .codec.codestream import LevelSection, VideoStream
from .codec.frame_codec import slope_to_threshold
from .config import CodecConfig
from .io.yuv import Video
from .mctf import motion_coding, transform
from .ops import cuda_lib
from .utils import trace


def _host(x):
    """numpy view of a (possibly device) tensor; numpy passes through."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _decode_plane_set(frames: List[Dict[str, frame_codec.EncodedFrame]],
                      threshold: float = 0.0, discard_levels: int = 0, *,
                      device):
    """Decoded (N, H, W) int32 stacks of one plane set, on ``device``.
    Backend planes decode on the host and are uploaded; they carry no
    resolution levels, so ``discard_levels`` needs internal frames."""
    if frames and isinstance(frames[0]["y"], backends.BackendFrame):
        if discard_levels:
            raise ValueError("SS extraction requires the internal "
                             "texture codec (backend frames carry no "
                             "resolution levels)")

        def dec(comp):
            # int32: the inverse MCTF subtracts the +128 bias — uint8
            # arithmetic would wrap
            stack = np.stack([
                backends.get(fr[comp].backend).decode(
                    fr[comp].payload, fr[comp].H, fr[comp].W, device=device)
                for fr in frames]).astype(np.int32)
            return torch.from_numpy(stack).to(device)
        return dec("y"), dec("u"), dec("v")
    return tuple(frame_codec.decode_frames([fr[c] for fr in frames],
                                           threshold, discard_levels,
                                           to_host=False, device=device)
                 for c in ("y", "u", "v"))


def _operating_point(cfg: CodecConfig, reversible: bool,
                     delta: Optional[float], lossless: Optional[bool]
                     ) -> Tuple[float, bool, str]:
    if lossless is None:
        lossless = reversible and cfg.quantization_texture <= 0
    if delta is None:
        # tie the 9/7 base quantization step to the operating point
        if not reversible and not lossless and cfg.quantization_texture > 0:
            t = slope_to_threshold(float(cfg.quantization_texture))
            delta = float(np.clip(math.sqrt(t) / 8.0, 0.125, 8.0))
        else:
            delta = 0.125
    return delta, lossless, cfg.texture_coder


def _upload(video: Video, device) -> Video:
    """uint8 planes on ``device`` (1 byte/pixel; widening happens in the
    transforms).  Tensors already there pass through."""
    def up(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.from_numpy(np.ascontiguousarray(x, np.uint8)).to(device)
    return Video(up(video.y), up(video.u), up(video.v))


def _pad_to_grid(video: Video, cfg: CodecConfig
                 ) -> Tuple[Video, CodecConfig,
                            Optional[Tuple[int, int]], Optional[int]]:
    """Pad arbitrary input to the coded grid: edge-replicate spatially and
    repeat the last frame temporally; the true geometry goes into the
    stream header and is cropped on decode.

    Returns (padded video, cfg with coded geometry, true (W,H) or None,
    true frame count or None)."""
    H, W, n = video.height, video.width, video.frames
    bs = cfg.auto_block_size if cfg.TRLs > 1 else 2
    Ht, Wt = -(-H // bs) * bs, -(-W // bs) * bs
    if cfg.TRLs > 1:
        S = cfg.gop_size
        gops = max(1, -(-(n - 1) // S))
        nt = gops * S + 1
    else:
        gops = cfg.GOPs
        nt = n
    if (Ht, Wt, nt) == (H, W, n):
        if (cfg.pixels_in_x, cfg.pixels_in_y, cfg.pictures) != (W, H, n):
            cfg = cfg.replace(pixels_in_x=W, pixels_in_y=H, GOPs=gops)
        return video, cfg, None, None

    def pad(plane, h, w, frames):
        def edge(size, new):
            return torch.arange(new, device=plane.device).clamp(max=size - 1)
        f, y, x = plane.shape
        return plane[edge(f, frames)][:, edge(y, h)][:, :, edge(x, w)]

    video = Video(pad(video.y, Ht, Wt, nt),
                  pad(video.u, Ht // 2, Wt // 2, nt),
                  pad(video.v, Ht // 2, Wt // 2, nt))
    cfg = cfg.replace(pixels_in_x=Wt, pixels_in_y=Ht, GOPs=gops)
    return (video, cfg,
            (W, H) if (Ht, Wt) != (H, W) else None,
            n if nt != n else None)


def compress_dispatch(video: Video, cfg: CodecConfig,
                      reversible: bool = True,
                      delta: Optional[float] = None,
                      lossless: Optional[bool] = None, *,
                      device="cuda") -> dict:
    """Queue the device side of an encode: upload, MCTF analyze, the
    texture DWT+quantize+tile+R-D simulation over one luma and one chroma
    stack, and the motion-field decorrelation.  Nothing waits for the
    device; the returned handle is drained by :func:`compress_finish`."""
    with trace.stage("upload+mctf_dispatch", frames=int(video.frames)):
        with trace.stage("upload"):     # pageable: waits for the stream
            video = _upload(video, device)
        video, cfg, true_dims, true_frames = _pad_to_grid(video, cfg)
        cfg.validate()
        delta, lossless, coder = _operating_point(cfg, reversible, delta,
                                                  lossless)
        if cfg.TRLs > 1:
            stream = transform.analyze_jit(video.y, video.u, video.v, cfg)
        else:
            stream = transform.MCTFStream(video.y.to(torch.int16),
                                          video.u.to(torch.int16),
                                          video.v.to(torch.int16), ())
    return _dispatch_stream(stream, cfg, reversible, delta, lossless,
                            coder, true_dims, true_frames)


def _dispatch_stream(stream: transform.MCTFStream, cfg: CodecConfig,
                     reversible: bool, delta: float, lossless: bool,
                     coder: str,
                     true_dims: Optional[Tuple[int, int]] = None,
                     true_frames: Optional[int] = None) -> dict:
    """The entropy side of an encode for a computed MCTF stream: every
    temporal subband keeps the full spatial resolution, so the low band
    and all high bands concatenate into one luma and one chroma stack."""
    srl_levels = cfg.SRLs - 1
    cb = cfg.codeblock_size
    slopes = cfg.slopes()

    def thr(row: int) -> float:
        if lossless:
            return 0.0
        return slope_to_threshold(slopes[row][0])

    luma_planes = [stream.low_y]
    chroma_planes = [stream.low_u, stream.low_v]
    luma_thr = [np.full(stream.low_y.shape[0], thr(0))]
    chroma_thr = [np.full(2 * stream.low_u.shape[0], thr(0))]
    for t, lev in enumerate(stream.levels, start=1):
        mt = thr(cfg.TRLs - t)
        luma_planes.append(lev.high_y)
        chroma_planes += [lev.high_u, lev.high_v]
        luma_thr.append(np.full(lev.high_y.shape[0], mt))
        chroma_thr.append(np.full(2 * lev.high_u.shape[0], mt))
    luma = torch.cat(luma_planes)
    chroma = torch.cat(chroma_planes)

    luma_thr_arr = np.concatenate(luma_thr)
    chroma_thr_arr = np.concatenate(chroma_thr)
    with trace.stage("texture_dispatch"):
        pend_l = frame_codec.encode_frames_dispatch_sparse(
            luma, srl_levels, reversible, delta, cb, luma_thr_arr, coder)
        pend_c = frame_codec.encode_frames_dispatch_sparse(
            chroma, srl_levels, reversible, delta, cb, chroma_thr_arr, coder)
        mv_fields = [lev.mv for lev in stream.levels]
        residues_dev = (motion_coding.decorrelate_jit(mv_fields)
                        if mv_fields else [])

    return dict(cfg=cfg, reversible=reversible, delta=delta,
                lossless=lossless, coder=coder, stream=stream,
                luma_shape=luma.shape, chroma_shape=chroma.shape,
                luma_thr=luma_thr_arr, chroma_thr=chroma_thr_arr,
                pend_l=pend_l, pend_c=pend_c, residues_dev=residues_dev,
                thr=thr, true_dims=true_dims, true_frames=true_frames)


def compress_finish_stats(pending: dict) -> dict:
    """Finish, phase 1: wait for the device encode, fetch the per-tile
    stats and MV residues, and slice the kept code-block prefixes."""
    pend_l, pend_c = pending["pend_l"], pending["pend_c"]
    with trace.stage("device_encode+stats_fetch"):
        stats_l = tuple(_host(t) for t in pend_l[2:5])
        stats_c = tuple(_host(t) for t in pend_c[2:5])
        residues = [_host(r) for r in pending["residues_dev"]]
    pending = dict(pending)
    coder = pending["coder"]
    with trace.stage("texture_select"):
        pending["_sel"] = (
            frame_codec.encode_frames_select_sparse(
                pend_l, pending["luma_thr"], coder, stats_l),
            frame_codec.encode_frames_select_sparse(
                pend_c, pending["chroma_thr"], coder, stats_c))
    pending["_residues"] = residues
    return pending


def compress_finish(pending: dict) -> VideoStream:
    """Drain one dispatched encode: fetch stats, fetch the surviving
    code-blocks, entropy-code them natively, assemble the container."""
    if "_sel" not in pending:
        pending = compress_finish_stats(pending)
    cfg = pending["cfg"]
    stream = pending["stream"]
    coder = pending["coder"]
    luma_thr, chroma_thr = pending["luma_thr"], pending["chroma_thr"]
    thr = pending["thr"]
    sel_l, sel_c = pending["_sel"]
    residues = pending["_residues"]

    with trace.stage("select+gather_fetch"):
        sel_l = sel_l[:1] + (_host(sel_l[1]),) + sel_l[2:]
        sel_c = sel_c[:1] + (_host(sel_c[1]),) + sel_c[2:]
    (_, Hl, Wl) = pending["luma_shape"]
    (_, Hc, Wc) = pending["chroma_shape"]
    with trace.stage("native_entropy_coding"):
        enc_l = frame_codec.encode_frames_finish_sparse(
            sel_l, Hl, Wl, luma_thr, coder)
        enc_c = frame_codec.encode_frames_finish_sparse(
            sel_c, Hc, Wc, chroma_thr, coder)

    # one native call for every motion field of every level
    with trace.stage("motion_coding"):
        all_fields = [residues[t][i] for t in range(len(stream.levels))
                      for i in range(residues[t].shape[0])]
        all_motion = codestream.encode_motion_fields(all_fields)

    def trunc(frames, row):
        t = thr(row)
        if t <= 0:
            return frames
        return [{c: ef.truncate(t) for c, ef in fr.items()} for fr in frames]

    # slice the consolidated results back into per-subband plane sets
    def plane_set(lo_y, lo_c, n):
        return [{"y": enc_l[lo_y + i], "u": enc_c[lo_c + i],
                 "v": enc_c[lo_c + n + i]} for i in range(n)]

    with trace.stage("assemble_stream"):
        n0 = stream.low_y.shape[0]
        low = trunc(plane_set(0, 0, n0), 0)
        levels: List[LevelSection] = []
        oy, oc = n0, 2 * n0
        mo = 0
        for t, lev in enumerate(stream.levels, start=1):
            p = lev.high_y.shape[0]
            high = trunc(plane_set(oy, oc, p), cfg.TRLs - t)
            oy += p
            oc += 2 * p
            motion = all_motion[mo:mo + p]
            mo += p
            ftypes = bytes(b"B"[0] if b else b"I"[0]
                           for b in _host(lev.is_B))
            levels.append(LevelSection(high, motion, ftypes))
        return VideoStream(cfg, pending["reversible"], pending["delta"],
                           low, levels, true_dims=pending["true_dims"],
                           true_frames=pending["true_frames"])


def _load_libraries(device) -> None:
    """Load, building at first use, the kernels of ``csrc/`` (for a CUDA
    ``device``) and the native coder."""
    if torch.device(device).type == "cuda":
        cuda_lib.load()
    fast.build_seconds()


def prewarm(cfg: CodecConfig, reversible: bool = False,
            delta: Optional[float] = None,
            lossless: Optional[bool] = None, *, device="cuda") -> float:
    """Pay ahead what the first GOP of ``cfg`` would pay on ``device``:
    load (building at first use) the kernels and the native coder, and
    run the encode's captured programs once, on a zero GOP of the
    production shapes dispatched as :func:`compress_chunks` dispatches
    every GOP (``cfg.replace(GOPs=1)``), so that each one's CUDA graph is
    captured: ``transform.analyze_jit``, ``frame_codec._encode_device_jit``
    for the luma and the chroma stack, ``motion_coding.decorrelate_jit``.
    On the CPU the same programs run eagerly, as the JAX package
    compiles them for the CPU.  Returns the seconds taken.

    The JAX function compiles the programs in four threads; a capture
    holds its device's lock, so here they run one after another."""
    t0 = time.perf_counter()
    with trace.stage("prewarm"):
        _load_libraries(device)
        gop_cfg = cfg.replace(GOPs=1)
        n, H, W = gop_cfg.pictures, gop_cfg.pixels_in_y, gop_cfg.pixels_in_x
        zero = Video(np.zeros((n, H, W), np.uint8),
                     np.zeros((n, H // 2, W // 2), np.uint8),
                     np.zeros((n, H // 2, W // 2), np.uint8))
        compress_finish_stats(compress_dispatch(
            zero, gop_cfg, reversible, delta, lossless, device=device))
    return time.perf_counter() - t0


def prewarm_decode(cfg: CodecConfig, reversible: bool = False,
                   delta: Optional[float] = None,
                   lossless: Optional[bool] = None, *,
                   device="cuda") -> float:
    """The decode's mirror of :func:`prewarm`: decode on ``device`` a
    zero GOP stream of ``cfg`` (every code-block empty, every frame a B
    frame with zero motion) through :func:`expand`, so that its captured
    programs are: ``frame_codec._dequant_idwt_jit`` for each plane-set
    geometry of a GOP, ``motion_coding.correlate_jit`` and
    ``transform.synthesize_jit``.  The programs are keyed by the
    configuration, so ``cfg`` is the streams' own (``streams[0].cfg``).
    The eager tile scatter (``frame_codec._scatter_tiles``) takes as many
    tiles as a GOP has coded code-blocks, a count that changes with every
    GOP, and is not warmed.  Returns the seconds taken."""
    t0 = time.perf_counter()
    with trace.stage("prewarm_decode"):
        _load_libraries(device)
        gop_cfg = cfg.replace(GOPs=1)
        delta, _, coder = _operating_point(gop_cfg, reversible, delta,
                                           lossless)
        expand(_zero_stream(gop_cfg, reversible, delta, coder),
               to_host=False, device=device)
    return time.perf_counter() - t0


def _zero_stream(cfg: CodecConfig, reversible: bool, delta: float,
                 coder: str) -> VideoStream:
    """The one-GOP stream of ``cfg`` that :func:`prewarm_decode` decodes:
    empty code-blocks, B frames, zero motion."""
    H, W = cfg.pixels_in_y, cfg.pixels_in_x
    levels, cb = cfg.SRLs - 1, cfg.codeblock_size

    def plane_set(n):
        def frame(h, w):
            return frame_codec.EncodedFrame(
                h, w, levels, reversible, delta, cb,
                frame_codec._empty_blocks(h, w, levels, cb), coder)
        return [{"y": frame(H, W), "u": frame(H // 2, W // 2),
                 "v": frame(H // 2, W // 2)} for _ in range(n)]

    sched = cfg.level_schedule()
    sections = []
    for lp in sched:
        p = lp.pictures // 2
        mv = np.zeros((2, 2, H // lp.block_size, W // lp.block_size),
                      np.int32)
        sections.append(LevelSection(
            plane_set(p), codestream.encode_motion_fields([mv] * p),
            b"B" * p))
    n_low = (sched[-1].pictures + 1) // 2 if sched else cfg.pictures
    return VideoStream(cfg, reversible, delta, plane_set(n_low), sections)


def _compress_with_backend(video: Video, cfg: CodecConfig, *,
                           device="cuda") -> VideoStream:
    """Encode with an alternative texture backend (codec/backends.py):
    the MCTF on ``device`` as usual, then each subband stack comes to the
    host once and every frame plane is coded by the selected per-plane
    codec instead of the internal DWT+EBCOT path.  Subband planes are
    already uint8-range (high bands stored +128-biased), so every backend
    sees plain grayscale planes."""
    be = backends.get(cfg.texture_backend)
    video = _upload(video, device)
    video, cfg, true_dims, true_frames = _pad_to_grid(video, cfg)
    cfg.validate()
    if cfg.TRLs > 1:
        stream = transform.analyze_jit(video.y, video.u, video.v, cfg)
    else:
        stream = transform.MCTFStream(video.y.to(torch.int16),
                                      video.u.to(torch.int16),
                                      video.v.to(torch.int16), ())
    q = 0.0 if be.lossless else float(cfg.quantization_texture)

    def enc_planes(py, pu, pv) -> List[Dict[str, backends.BackendFrame]]:
        ay, au, av = _host(py), _host(pu), _host(pv)
        out = []
        for i in range(ay.shape[0]):
            fr = {}
            for comp, a in (("y", ay), ("u", au), ("v", av)):
                p = np.clip(a[i], 0, 255).astype(np.uint8)
                fr[comp] = backends.BackendFrame(
                    be.name, p.shape[0], p.shape[1],
                    be.encode(p, q, device=device))
            out.append(fr)
        return out

    low = enc_planes(stream.low_y, stream.low_u, stream.low_v)
    mv_fields = [lev.mv for lev in stream.levels]
    residues = ([_host(r) for r in motion_coding.decorrelate_jit(mv_fields)]
                if mv_fields else [])
    levels: List[LevelSection] = []
    for t, lev in enumerate(stream.levels):
        high = enc_planes(lev.high_y, lev.high_u, lev.high_v)
        motion = codestream.encode_motion_fields(list(residues[t]))
        ftypes = bytes(b"B"[0] if b else b"I"[0] for b in _host(lev.is_B))
        levels.append(LevelSection(high, motion, ftypes))
    # header metadata reflects the backend: a lossy backend's stream is
    # not reversible, and delta is unused (backends quantize on their
    # own) — 0.0 marks it so
    return VideoStream(cfg, be.lossless, 0.0, low, levels,
                       true_dims=true_dims, true_frames=true_frames)


def compress(video: Video, cfg: CodecConfig, reversible: bool = True,
             delta: Optional[float] = None, lossless: Optional[bool] = None,
             *, device="cuda") -> VideoStream:
    """Encode a video to a :class:`VideoStream` on ``device``.

    ``reversible``: integer 5/3 texture path; with ``lossless=True``
    (default when reversible and ``quantization_texture <= 0``) nothing is
    truncated.  Otherwise blocks are truncated at the per-subband slope
    thresholds of ``cfg.slopes()``.  ``cfg.texture_backend`` other than
    "internal" routes the texture through :mod:`.codec.backends`."""
    if cfg.texture_backend != "internal":
        return _compress_with_backend(video, cfg, device=device)
    return compress_finish(compress_dispatch(video, cfg, reversible, delta,
                                             lossless, device=device))


def compress_gops(video: Video, cfg: CodecConfig, reversible: bool = True,
                  delta: Optional[float] = None,
                  lossless: Optional[bool] = None,
                  window: int = 2, *, device="cuda"
                  ) -> List[VideoStream]:
    """Streaming encode: one self-contained :class:`VideoStream` per GOP
    (GOPs share their boundary frame), pipelined ``window`` GOPs deep."""
    S = cfg.gop_size
    gop_cfg = cfg.replace(GOPs=1)
    G = max(1, -(-(video.frames - 1) // S)) if cfg.TRLs > 1 else cfg.GOPs
    chunks = [video[g * S:(g + 1) * S + 1] for g in range(G)]
    return compress_chunks(chunks, gop_cfg, reversible, delta, lossless,
                           window, device=device)


def compress_chunks(chunks, gop_cfg: CodecConfig,
                    reversible: bool = True, delta: Optional[float] = None,
                    lossless: Optional[bool] = None,
                    window: int = 2, progress=None, *, device="cuda"
                    ) -> List[VideoStream]:
    """Pipelined encode of a list of (already sliced) GOP chunks.

    GOP ``g``'s stats fetch runs before GOP ``g+window``'s dispatch, and
    the host entropy coding of GOP ``g`` overlaps the device work queued
    for the GOPs after it.  ``progress(index, stream)`` is called as each
    GOP's stream is finished, in order; the streams it is handed are not
    kept, and the call then returns an empty list, so that a feed of any
    length (``chunks`` may be a generator) holds only the GOPs in flight
    and the collector's full passes do not walk every stream so far.
    This differs from ``qsvc_tpu.api.compress_chunks``, which returns
    every stream with or without ``progress``; without ``progress`` both
    return the streams.  A texture backend codes on the host, GOP after
    GOP, with no pipeline."""
    out: List[VideoStream] = []
    index = 0

    def done(vs: VideoStream) -> None:
        nonlocal index
        if progress is None:
            out.append(vs)
        else:
            progress(index, vs)
        index += 1

    if gop_cfg.texture_backend != "internal":
        for chunk in chunks:
            done(_compress_with_backend(chunk, gop_cfg, device=device))
        return out
    pendings: List[dict] = []

    def finish_one():
        done(compress_finish(pendings.pop(0)))

    for chunk in chunks:
        if len(pendings) >= max(window, 1):
            finish_one()
        if pendings and "_sel" not in pendings[0]:
            pendings[0] = compress_finish_stats(pendings[0])
        pendings.append(compress_dispatch(chunk, gop_cfg, reversible,
                                          delta, lossless, device=device))
    while pendings:
        finish_one()
    return out


def expand_gops(streams: List[VideoStream], *, device="cuda", **kw
                ) -> Video:
    """Decode a per-GOP stream list back to one host sequence (drops the
    duplicated shared boundary frames); two GOPs decode concurrently."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=2) as ex:
        vids = list(ex.map(lambda vs: expand(vs, device=device, **kw),
                           streams))
    y = np.concatenate([v.y[:-1] for v in vids] + [vids[-1].y[-1:]])
    u = np.concatenate([v.u[:-1] for v in vids] + [vids[-1].u[-1:]])
    v_ = np.concatenate([v.v[:-1] for v in vids] + [vids[-1].v[-1:]])
    return Video(y, u, v_)


def expand(vs: VideoStream, threshold: float = 0.0,
           discard_TRLs: int = 0, to_host: bool = True, *,
           device="cuda") -> Video:
    """Decode a :class:`VideoStream` on ``device``.

    ``threshold``: extra decode-time slope truncation (QS); ``discard_TRLs``:
    drop the finest temporal levels (TS).  ``to_host=False`` returns uint8
    planes on ``device`` (the staged decode), after waiting for them."""
    cfg = vs.cfg
    ly, lu, lv = _decode_plane_set(vs.low, threshold, device=device)
    use_levels = vs.levels[discard_TRLs:]

    lev_data = []
    residue_fields = []
    for lev in use_levels:
        hy, hu, hv = _decode_plane_set(lev.high, threshold, device=device)
        with trace.stage("decode.motion"):
            res = [codestream.decode_motion_field(m) for m in lev.motion]
        if res:
            residue_fields.append(torch.from_numpy(np.stack(res)).to(device))
        is_b = np.frombuffer(lev.frame_types, np.uint8) == ord("B")
        lev_data.append((hy, hu, hv, torch.from_numpy(is_b).to(device)))

    # reconstruct motion fields (inverse inter-level/bidirectional coding)
    mv_fields = (motion_coding.correlate_jit(residue_fields)
                 if residue_fields else [])
    levels = tuple(transform.LevelData(hy, hu, hv, mv.to(torch.int32), is_b)
                   for (hy, hu, hv, is_b), mv in zip(lev_data, mv_fields))
    mstream = transform.MCTFStream(ly, lu, lv, levels)
    with trace.stage("decode.synthesize_dispatch"):
        if not levels:
            ry, ru, rv = ly, lu, lv
        else:
            ry, ru, rv = transform.synthesize_jit(mstream, cfg,
                                                  discard_TRLs)
        ry, ru, rv = (p.to(torch.uint8) for p in (ry, ru, rv))
    if not to_host:
        with trace.stage("decode.wait_device"):
            if ry.is_cuda:
                torch.cuda.synchronize(ry.device)
        vid = Video(ry, ru, rv)
    else:
        with trace.stage("decode.output_download"):
            vid = Video(_host(ry), _host(ru), _host(rv))
    if vs.true_dims is not None or vs.true_frames is not None:
        tw, th = vs.true_dims or (vid.width, vid.height)
        tf = vs.true_frames if vs.true_frames is not None else vid.frames
        if discard_TRLs:     # frames surviving at the reduced rate
            tf = (tf - 1) // 2 ** discard_TRLs + 1
        ch, cw = -(-th // 2), -(-tw // 2)       # ceil: odd true dims
        vid = Video(vid.y[:tf, :th, :tw],
                    vid.u[:tf, :ch, :cw], vid.v[:tf, :ch, :cw])
    return vid


def compress_bytes(video: Video, cfg: CodecConfig, **kw) -> bytes:
    return compress(video, cfg, **kw).to_bytes()


def expand_bytes(data: bytes, **kw) -> Video:
    return expand(VideoStream.from_bytes(data), **kw)
