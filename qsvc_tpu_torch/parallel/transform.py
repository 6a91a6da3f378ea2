"""Distributed MCTF: GOP chunks spread over the ranks of a process
group, boundary halos exchanged point to point.

Port of ``qsvc_tpu/parallel/transform.py``.  Each rank runs the full
temporal transform of its own chunk (split, ME, predict: all inside the
chunk, since a chunk carries both of its boundary frames); only the MCTF
**update** couples neighbouring chunks through the shared boundary
frame.  In the sequential transform that frame receives the NEXT update
from the last pair of chunk ``c`` and the PREV update from the first
pair of chunk ``c+1``.  Here that is two halo exchanges of one 4:4:4
frame per temporal level:

  phase 1: every rank applies its NEXT updates to ``even[1:]``; the
           updated right boundary goes to rank+1, where it replaces the
           left boundary copy;
  phase 2: every rank applies its PREV updates to ``even[:-1]`` (the
           received left boundary now holds both contributions, in the
           sequential order); the finished left boundary goes to rank-1,
           so both copies of the shared frame agree.

Synthesis mirrors it with sign -1.  The JAX version's ``ppermute`` ring
wraps around and masks the wrapped value away; here the first rank
receives nothing from the left and the last nothing from the right,
which gives the same result.  Each update is one direction at a time,
``update.update_fields_batch`` (kernel K4 on the card), because the
halo sits between the two directions.  Everything else is the sequential
level code of ``mctf/transform.py``, handed this update step in place of
its own.

SPMD: every rank calls these functions with its own chunk, (k*S+1, H, W)
planes on ``mesh.device``, and gets its own :class:`MCTFStream` back.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..config import CodecConfig
from ..mctf import transform, update
from ..mctf.transform import MCTFStream, Planes
from ..ops import dwt2d
from ..utils import trace
from .mesh import HALO_SPAN, GopMesh


def _shift(x: torch.Tensor, mesh: GopMesh, step: int
           ) -> Optional[torch.Tensor]:
    """Send ``x`` to rank+step and receive rank-step's ``x``: one
    ``batch_isend_irecv`` with the send and the receive this rank has
    (none across the ends of the chunk run).  Returns the received frame,
    or None on the rank with no such neighbour.  The frame travels as its
    bytes: nccl takes no int16 tensor.  With nccl the wait orders the
    current stream after the exchange and does not block the host; the
    caching allocator keeps both buffers until the exchange is done.
    Under a ``utils.trace`` run log the exchange is the device span
    ``halo.exchange`` with the payload bytes ``sent`` and ``received``."""
    dst, src = mesh.rank + step, mesh.rank - step
    if mesh.size == 1:
        return None
    nbytes = x.numel() * x.element_size()
    sends, receives = 0 <= dst < mesh.size, 0 <= src < mesh.size
    with trace.device_stage(HALO_SPAN, x.device,
                            sent=nbytes if sends else 0,
                            received=nbytes if receives else 0):
        host = torch.device("cpu") if mesh.host_staged else x.device
        payload = x.to(host).contiguous().view(torch.uint8)
        ops = []
        if sends:
            ops.append(dist.P2POp(dist.isend, payload, group=mesh.group,
                                  group_peer=dst))
        got = None
        if receives:
            got = torch.empty_like(payload)
            ops.append(dist.P2POp(dist.irecv, got, group=mesh.group,
                                  group_peer=src))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return None if got is None else got.view(x.dtype).to(x.device)


def _right_shift(x, mesh):
    """Receive the left neighbour's value (rank i gets i-1's x)."""
    return _shift(x, mesh, 1)


def _left_shift(x, mesh):
    """Receive the right neighbour's value (rank i gets i+1's x)."""
    return _shift(x, mesh, -1)


def _update_with_halos(ev444: torch.Tensor, res444: torch.Tensor,
                       mv: torch.Tensor, block_size: int, search_range: int,
                       cfg: CodecConfig, sign: int, mesh: GopMesh
                       ) -> torch.Tensor:
    """Both update phases on a chunk's evens (a new tensor), with the
    halo exchange between them: the sharded counterpart of
    ``mctf.transform._update_evens``."""
    upd_prev = update.update_fields_batch(
        res444, mv[:, 0, 0], mv[:, 0, 1], block_size, cfg.update_factor,
        search_range)
    upd_next = update.update_fields_batch(
        res444, mv[:, 1, 0], mv[:, 1, 1], block_size, cfg.update_factor,
        search_range)
    ev444 = ev444.clone()
    # phase 1: NEXT updates (evens 1..k locally)
    ev444[1:] = update.apply_update(ev444[1:], upd_next, sign)
    # halo: rank c's updated right boundary -> rank c+1's left copy
    from_left = _right_shift(ev444[-1], mesh)
    if from_left is not None:
        ev444[0] = from_left
    # phase 2: PREV updates (evens 0..k-1 locally)
    ev444[:-1] = update.apply_update(ev444[:-1], upd_prev, sign)
    # halo back: rank c+1's finished left boundary -> rank c's right copy
    from_right = _left_shift(ev444[0], mesh)
    if from_right is not None:
        ev444[-1] = from_right
    return ev444


def _check_chunk(planes, cfg: CodecConfig, mesh: GopMesh) -> None:
    for p in planes:
        if p.device != mesh.device:
            raise ValueError(f"chunk on {p.device}, mesh on {mesh.device}")
    n = planes[0].shape[0] - 1
    if n <= 0 or n % cfg.gop_size:
        raise ValueError(f"a chunk holds k*{cfg.gop_size}+1 frames, got "
                         f"{n + 1}")


def analyze_sharded(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    cfg: CodecConfig, mesh: GopMesh) -> MCTFStream:
    """Distributed forward MCTF of this rank's chunk.

    ``y``: (k*S+1, H, W) on ``mesh.device`` (k GOPs of this rank, both
    boundary frames included); chroma likewise.  A chunk is a shorter
    open-GOP sequence: the level loop reads block size and search range
    from the schedule and frame counts from the shapes, and the halos
    couple chunk edges as they couple GOPs inside one chunk.  Every rank
    must call this with a chunk of the same shape.  Returns this rank's
    :class:`MCTFStream`."""
    _check_chunk((y, u, v), cfg, mesh)
    return transform._analyze(y, u, v, cfg,
                              partial(_update_with_halos, mesh=mesh))


def synthesize_sharded(stream: MCTFStream, cfg: CodecConfig,
                       mesh: GopMesh) -> Planes:
    """Distributed inverse MCTF of this rank's chunk stream; returns the
    chunk's (k*S+1, H, W) int16 planes, boundary frames included."""
    for p in (stream.low_y, stream.low_u, stream.low_v):
        if p.device != mesh.device:
            raise ValueError(f"stream on {p.device}, mesh on {mesh.device}")
    return transform._synthesize(stream, cfg, 0,
                                 partial(_update_with_halos, mesh=mesh))


def encode_step_sharded(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        cfg: CodecConfig, mesh: GopMesh) -> Dict:
    """The device side of a distributed encode of this rank's chunk: the
    sharded MCTF, then the packed 5/3 DWT (``SRLs-1`` levels) of every
    subband frame (the coefficient planes that entropy coding consumes).
    Returns ``{"low": (y, u, v), "levels": ((hy, hu, hv, mv, is_B), ...)}``.
    """
    srl = cfg.SRLs - 1
    st = analyze_sharded(y, u, v, cfg, mesh)

    def dwt(frames):
        return dwt2d.analyze(frames - 128, srl, "5/3")

    return {
        "low": tuple(dwt(x) for x in (st.low_y, st.low_u, st.low_v)),
        "levels": tuple((dwt(lev.high_y), dwt(lev.high_u), dwt(lev.high_v),
                         lev.mv, lev.is_B) for lev in st.levels),
    }
