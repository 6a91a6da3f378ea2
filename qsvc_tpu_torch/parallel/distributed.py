"""Multi-process distribution: the ``torch.distributed`` process group,
the GOP mesh, GOP sharding, and the two distributed encodes.

Port of ``qsvc_tpu/parallel/distributed.py``.  The sequence's GOP axis is
spread over the ranks of a process group, one contiguous run of GOPs per
rank (one rank per card with ``nccl``, the deployment; ``gloo`` for CPU
ranks, or for ranks that share one card):

* :func:`initialize` joins the process group from explicit arguments or
  from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``); with neither it does nothing, and every helper then
  runs as rank 0 of 1;
* :func:`compress_distributed` is the open-GOP, halo-exact encode: the
  sharded MCTF of :mod:`.transform` on every rank, the entropy coding of
  each rank's chunk through the sequential encoder's own
  ``api._dispatch_stream``, and the chunk fragments gathered to every
  rank and reassembled — byte-identical to ``api.compress`` of the whole
  sequence;
* :func:`encode_gops_distributed` is the closed-GOP encode: each rank
  encodes its own GOPs as independent streams and every rank gets the
  ordered list — byte-identical to ``api.compress_gops``;
* :func:`measure_scaling` is the scaling harness: the sharded encode
  step's fps on one rank against ``n``, each point a process group of
  its own spawned worker processes (``python -m
  qsvc_tpu_torch.parallel.scaling`` writes a sweep to a file).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import CodecConfig
from ..io.yuv import Video
from ..utils import trace
from . import mesh as pmesh
from . import transform as ptransform


def initialize(device="cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """Join the process group of this encode.

    The backend follows ``device``: ``nccl`` for a CUDA device (which
    becomes this process's current device and the group's bound device),
    ``gloo`` for the CPU.
    ``init_method`` (``tcp://host:port`` or ``file://path``) with
    ``world_size`` and ``rank``, or else torchrun's ``RANK`` and
    ``WORLD_SIZE`` with ``MASTER_ADDR``/``MASTER_PORT`` (``env://``).  With
    neither, or with a group already up, this does nothing."""
    if dist.is_initialized():
        return
    if init_method is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if world_size is None or rank is None:
        raise ValueError("init_method needs world_size and rank")
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)     # before the group exists
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=init_method,
                            world_size=int(world_size), rank=int(rank),
                            device_id=device if cuda else None)


def end_group() -> None:
    """End this rank's process group, the same way on every rank and
    either backend: a barrier, so that no rank tears down while a peer
    still sends to it; on ``nccl`` a wait for the card's queued work; then
    the group's destruction.  Without a group this does nothing.

    Every rank that joined a group with :func:`initialize` leaves it
    through this, after its last collective and before it returns."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dev = torch.cuda.current_device()
        dist.barrier(device_ids=[dev])
        torch.cuda.synchronize(dev)
    else:
        dist.barrier()
    dist.destroy_process_group()


def make_gop_mesh(device="cuda", group=None) -> pmesh.GopMesh:
    """The GOP mesh of this process on ``device`` (see
    :func:`.mesh.make_mesh`): group rank r owns the r-th run of GOPs, so
    halo traffic flows only between consecutive ranks."""
    return pmesh.make_mesh(device, group)


def _group_mesh() -> pmesh.GopMesh:
    """The mesh of the default process group, for an encode given no
    mesh: on the card :func:`initialize` bound for ``nccl``, on the CPU
    for ``gloo``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize() first, or "
                           "pass a mesh")
    if dist.get_backend() == "nccl":
        return make_gop_mesh(torch.device("cuda",
                                          torch.cuda.current_device()))
    return make_gop_mesh("cpu")


def _gops_per_rank(G: int, mesh: pmesh.GopMesh) -> int:
    if G % mesh.size:
        raise ValueError(f"{G} GOPs do not split evenly over {mesh.size} "
                         f"ranks")
    return G // mesh.size


def shard_video_gops(video: Video, cfg: CodecConfig, mesh: pmesh.GopMesh
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's chunk of a ``G*S+1``-frame video: frames ``[r*k*S,
    (r+1)*k*S]`` with k = G / D GOPs per rank (the r-th row of
    ``mesh.shard_gops(plane, k*S)``), as uint8 planes on ``mesh.device``.
    """
    from .. import api
    S = cfg.gop_size * _gops_per_rank(cfg.GOPs, mesh)
    chunk = video[mesh.rank * S:(mesh.rank + 1) * S + 1]
    return api._upload(chunk, mesh.device).planes()


def encode_gops_distributed(video: Video, cfg: CodecConfig,
                            mesh: Optional[pmesh.GopMesh] = None,
                            reversible: bool = False) -> List[bytes]:
    """Closed-GOP distributed encode: each rank encodes its own GOPs as
    self-contained streams (``api.compress`` with ``GOPs=1`` on
    ``mesh.device``); every rank returns the ordered list of all
    ``cfg.GOPs`` streams' bytes.  Without ``mesh``, the mesh of the
    default process group (:func:`initialize` first)."""
    from .. import api
    if mesh is None:
        mesh = _group_mesh()
    G = cfg.GOPs
    k = _gops_per_rank(G, mesh)
    gop_cfg = cfg.replace(GOPs=1)
    S = cfg.gop_size
    payloads = []
    for g in range(mesh.rank * k, (mesh.rank + 1) * k):
        vs = api.compress(video[g * S:(g + 1) * S + 1], gop_cfg,
                          reversible=reversible, device=mesh.device)
        payloads.append((g, vs.to_bytes()))
    if mesh.size == 1:
        return [p for _, p in sorted(payloads)]
    return _allgather_indexed_bytes(payloads, G, mesh)


def _allgather_indexed_bytes(payloads: List[Tuple[int, bytes]], total: int,
                             mesh: pmesh.GopMesh) -> List[bytes]:
    """Gather ``total`` index-tagged byte blobs from every rank to every
    rank; returns them ordered by index."""
    gathered: List[Optional[list]] = [None] * mesh.size
    dist.all_gather_object(gathered, payloads, group=mesh.group)
    out: List[Optional[bytes]] = [None] * total
    for part in gathered:
        for g, blob in part:
            out[g] = blob
    missing = [g for g, b in enumerate(out) if b is None]
    if missing:
        raise RuntimeError(f"no rank returned blobs {missing}")
    return out  # type: ignore[return-value]


def compress_distributed(video: Video, cfg: CodecConfig,
                         mesh: Optional[pmesh.GopMesh] = None,
                         reversible: bool = False, delta=None,
                         lossless=None):
    """Halo-exact distributed encode: byte-identical to the sequential
    ``api.compress`` of the whole sequence on every rank.

    Every rank pads the video to the coded grid as ``api.compress`` does,
    runs :func:`.transform.analyze_sharded` on its chunk (the open-GOP
    MCTF whose halo exchanges reproduce the sequential update's coupling
    across chunks), entropy-codes the chunk through the sequential
    encoder's own ``api._dispatch_stream`` (per-frame encodes do not
    depend on the stack, so per-chunk stacks give the same bytes), and
    the chunk fragments are gathered and reassembled into one
    sequential-layout :class:`VideoStream`.

    Without ``mesh``, the mesh of the default process group
    (:func:`initialize` first).  Contrast :func:`encode_gops_distributed`,
    whose per-GOP streams are closed and decodable on their own."""
    from .. import api
    from ..codec.codestream import LevelSection, VideoStream

    if cfg.TRLs <= 1:
        raise ValueError("the distributed encode needs a temporal "
                         "transform (TRLs > 1)")
    if mesh is None:
        mesh = _group_mesh()
    if not isinstance(video.y, torch.Tensor):
        video = api._upload(video, "cpu")  # uint8 frames: a view, no copy
    video, cfg, true_dims, true_frames = api._pad_to_grid(video, cfg)
    cfg.validate()
    D = mesh.size
    k = _gops_per_rank(cfg.GOPs, mesh)
    ccfg = cfg.replace(GOPs=k)          # one chunk's stream layout
    delta, lossless, coder = api._operating_point(cfg, reversible, delta,
                                                  lossless)

    with trace.stage("upload+sharded_mctf_dispatch"):
        gy, gu, gv = shard_video_gops(video, cfg, mesh)
        st = ptransform.analyze_sharded(gy, gu, gv, cfg, mesh)
    # drop the duplicated right-boundary low frame everywhere but on the
    # last chunk (the sequential low band has G*(S/2^{T-1}) + 1 frames)
    trim = slice(None) if mesh.rank == D - 1 else slice(None, -1)
    sub = st._replace(low_y=st.low_y[trim], low_u=st.low_u[trim],
                      low_v=st.low_v[trim])
    frag = api.compress_finish(api._dispatch_stream(
        sub, ccfg, reversible, delta, lossless, coder))

    if D == 1:
        frags = [frag]
    else:
        with trace.stage("gather_fragments"):
            blobs = _allgather_indexed_bytes(
                [(mesh.rank, frag.to_bytes())], D, mesh)
        with trace.stage("parse_fragments"):
            frags = [VideoStream.from_bytes(b) for b in blobs]

    low = [fr for f in frags for fr in f.low]
    levels_out: List[LevelSection] = []
    for t in range(cfg.TRLs - 1):
        high = [fr for f in frags for fr in f.levels[t].high]
        motion = [m for f in frags for m in f.levels[t].motion]
        ftypes = b"".join(bytes(f.levels[t].frame_types) for f in frags)
        levels_out.append(LevelSection(high, motion, ftypes))
    return VideoStream(cfg, reversible, delta, low, levels_out,
                       true_dims=true_dims, true_frames=true_frames)


#: the scaling harness's default configuration (the JAX package's):
#: large enough that per-call overheads do not swamp the encode
SCALING_CONFIG = CodecConfig(pixels_in_x=512, pixels_in_y=512, TRLs=3,
                             block_size=32, search_range=4,
                             update_factor=0.25, SRLs=4)
#: timed calls of the encode step per scaling point, after one warm-up
SCALING_REPS = 2
#: seconds a group of spawned ranks may take, start-up included
RANKS_TIMEOUT_S = 900


def _check_cards(n: int, device: torch.device) -> None:
    """Raise unless each of ``n`` CUDA ranks can have a card of its own."""
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks need {n} cards (one rank per card); "
                         f"{torch.cuda.device_count()} are visible")


def _rank_main(rank: int, target, n: int, store: str, outdir: str,
               args: tuple) -> None:
    """A spawned rank of :func:`run_ranks`: ``target``'s result to a
    file of ``outdir``."""
    out = target(rank, n, store, *args)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(target, n: int, *args, timeout: float = RANKS_TIMEOUT_S
              ) -> List:
    """Run ``target(rank, n, store, *args)`` in ``n`` processes of
    ``torch.multiprocessing.spawn``, ``store`` a ``file://`` rendezvous
    path in a temp dir (for :func:`initialize` or
    ``init_process_group``); returns the ranks' results in rank order.
    When a rank fails, or ``timeout`` seconds pass, every rank still
    running is stopped, and this raises."""
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mp.spawn(_rank_main, args=(target, n,
                                           os.path.join(tmp, "store"), tmp,
                                           args), nprocs=n, join=False)
        deadline = time.monotonic() + timeout
        try:
            # join stops the peers of a failed rank, which would wait on it
            while not ranks.join(max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"ranks failed: still running after "
                                       f"{timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"ranks failed: {e}") from e
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _scaling_rank(rank: int, n: int, store: str, reps: int,
                  cfg: CodecConfig, device: str) -> Dict:
    """One rank of a scaling point: joins the group, runs
    ``encode_step_sharded`` on its chunk once to warm up and ``reps``
    times timed; returns its seconds per call, the halo exchanges' seconds
    and payload bytes (sent and received) per timed call, and its kernel
    launches."""
    from ..io import synthetic_video
    from ..ops import cuda_lib
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(
        device)
    initialize(dev, init_method=f"file://{store}", world_size=n, rank=rank)
    # only the halo exchanges' spans, so that the timed calls carry no
    # other tracing; installed before the warm-up, so that the log's
    # device anchor is taken outside them
    log = trace.RunLog(only=(pmesh.HALO_SPAN,))
    trace.set_run_log(log)
    try:
        mesh = make_gop_mesh(dev)
        vid = synthetic_video(cfg.pictures, cfg.pixels_in_y,
                              cfg.pixels_in_x, seed=0)
        planes = shard_video_gops(vid, cfg, mesh)

        def step():
            ptransform.encode_step_sharded(*planes, cfg, mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        cuda_lib.reset_launches()
        step()                                   # warm-up
        log.clear()
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        dt = (time.perf_counter() - t0) / reps
        trace.set_run_log(None)
        halo = pmesh.halo_totals(log.records)
        out = {"seconds": dt, "halo_seconds": halo["seconds"] / reps,
               "halo_bytes": (halo["sent"] + halo["received"]) // reps,
               "launches": dict(cuda_lib.launches)}
        end_group()
        return out
    finally:
        trace.set_run_log(None)
        if dist.is_initialized():           # a failed rank: no barrier
            dist.destroy_process_group()


def scaling_point(n: int, reps: int = SCALING_REPS,
                  cfg: Optional[CodecConfig] = None, *,
                  device="cuda") -> Dict:
    """One point of :func:`measure_scaling`: ``encode_step_sharded`` of
    ``n`` GOPs of ``cfg`` on ``n`` ranks (:func:`run_ranks`; ``nccl``
    with rank r on ``cuda:r`` for a CUDA ``device``, ``gloo`` for the
    CPU).  Returns ``{n, fps, seconds, rank_seconds, rank_halo_seconds,
    rank_halo_bytes, launches}``: the frames of the ``n``-GOP sequence
    over the slowest rank's seconds per call, each rank's seconds, halo
    seconds and halo payload bytes per call, and the kernel launches of
    all ranks over the warm-up and the timed calls."""
    device = torch.device(device)
    _check_cards(n, device)
    c = (cfg or SCALING_CONFIG).replace(GOPs=n)
    ranks = run_ranks(_scaling_rank, n, reps, c, device.type)
    seconds = max(r["seconds"] for r in ranks)
    launches: Dict[str, int] = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"n": n, "fps": c.pictures / seconds, "seconds": seconds,
            "rank_seconds": [r["seconds"] for r in ranks],
            "rank_halo_seconds": [r["halo_seconds"] for r in ranks],
            "rank_halo_bytes": [r["halo_bytes"] for r in ranks],
            "launches": launches}


def efficiency(point: Dict, one: Dict) -> float:
    """fps_n / (n * fps_1) of a :func:`scaling_point` against the n = 1
    point."""
    return point["fps"] / (point["n"] * one["fps"])


def measure_scaling(n_devices: int, reps: int = SCALING_REPS,
                    cfg: Optional[CodecConfig] = None, *,
                    device="cuda") -> Dict:
    """Scaling efficiency of the sharded encode step: fps on one rank
    against ``n_devices`` ranks with the same work per rank (one GOP of
    ``cfg``, by default :data:`SCALING_CONFIG`), each point a
    :func:`scaling_point`.  Returns ``{n_devices, fps_1, fps_n,
    efficiency, launches, points}`` with efficiency = fps_n / (n * fps_1),
    and the launches of each point and the point itself by its ``n``; at
    ``n_devices`` = 1 the one point is both.  With a CUDA ``device`` every
    rank has its own card: more ranks than cards raise."""
    _check_cards(n_devices, torch.device(device))
    one = scaling_point(1, reps, cfg, device=device)
    many = (one if n_devices == 1
            else scaling_point(n_devices, reps, cfg, device=device))
    return {"n_devices": n_devices, "fps_1": one["fps"],
            "fps_n": many["fps"], "efficiency": efficiency(many, one),
            "launches": {1: one["launches"], n_devices: many["launches"]},
            "points": {1: one, n_devices: many}}
