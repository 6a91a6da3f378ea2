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
  ordered list — byte-identical to ``api.compress_gops``.

The scaling harness of the JAX module (``measure_scaling``) is not
ported yet.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import CodecConfig
from ..io.yuv import Video
from . import mesh as pmesh
from . import transform as ptransform


def initialize(device, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """Join the process group of this encode.

    The backend follows ``device``: ``nccl`` for a CUDA device (which
    becomes this process's current device), ``gloo`` for the CPU.
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
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method,
                            world_size=int(world_size), rank=int(rank))


def make_gop_mesh(device, group=None) -> pmesh.GopMesh:
    """The GOP mesh of this process on ``device`` (see
    :func:`.mesh.make_mesh`): group rank r owns the r-th run of GOPs, so
    halo traffic flows only between consecutive ranks."""
    return pmesh.make_mesh(device, group)


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
                            mesh: pmesh.GopMesh,
                            reversible: bool = False) -> List[bytes]:
    """Closed-GOP distributed encode: each rank encodes its own GOPs as
    self-contained streams (``api.compress`` with ``GOPs=1`` on
    ``mesh.device``); every rank returns the ordered list of all
    ``cfg.GOPs`` streams' bytes."""
    from .. import api
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
                         mesh: pmesh.GopMesh, reversible: bool = False,
                         delta=None, lossless=None):
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

    Contrast :func:`encode_gops_distributed`, whose per-GOP streams are
    closed and decodable on their own."""
    from .. import api
    from ..codec.codestream import LevelSection, VideoStream

    if cfg.TRLs <= 1:
        raise ValueError("the distributed encode needs a temporal "
                         "transform (TRLs > 1)")
    if not isinstance(video.y, torch.Tensor):
        video = api._upload(video, "cpu")  # uint8 frames: a view, no copy
    video, cfg, true_dims, true_frames = api._pad_to_grid(video, cfg)
    cfg.validate()
    D = mesh.size
    k = _gops_per_rank(cfg.GOPs, mesh)
    ccfg = cfg.replace(GOPs=k)          # one chunk's stream layout
    delta, lossless, coder = api._operating_point(cfg, reversible, delta,
                                                  lossless)

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
        blobs = _allgather_indexed_bytes([(mesh.rank, frag.to_bytes())],
                                         D, mesh)
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
