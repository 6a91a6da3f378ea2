"""GOP mesh and GOP sharding.

Port of ``qsvc_tpu/parallel/mesh.py``.  The sequence's ``G*S+1`` frames
are cut into ``(G, S+1, ...)`` chunks with the shared boundary frame
duplicated (the open-GOP rule), and the chunks are spread over the ranks
of a ``torch.distributed`` process group, one contiguous run of GOPs per
rank.  :class:`GopMesh` takes the place of the JAX package's
``jax.sharding.Mesh`` with its one ``gop`` axis: it names this process's
rank, the group's size, the device this rank computes on, and the group.

Without an initialised process group the mesh is rank 0 of 1 (one
process holds every GOP): the same code then runs on one device with no
communication.  The device is always the one passed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


#: the device span ``parallel.transform`` opens around each halo exchange
HALO_SPAN = "halo.exchange"


def halo_totals(records: List[dict]) -> dict:
    """What the halo exchanges in ``records`` (a ``utils.trace`` run log's)
    cost: their count, the payload bytes sent and received, and their
    summed device seconds (on a CUDA device the time the compute stream
    waited for each exchange, the peer's lateness included)."""
    spans = [r for r in records if r.get("device_stage") == HALO_SPAN]
    return {"exchanges": len(spans),
            "sent": sum(r["sent"] for r in spans),
            "received": sum(r["received"] for r in spans),
            "seconds": sum(r["device_seconds"] for r in spans)}


@dataclass(frozen=True)
class GopMesh:
    """This process's place on the ``gop`` axis."""
    rank: int                      # index of this rank's chunk
    size: int                      # number of ranks (chunks)
    device: torch.device           # where this rank's chunk is computed
    #: the process group; None: the default group (or none: one process)
    group: Optional[object] = None
    #: halo frames go through host memory (gloo takes CPU tensors only);
    #: False for nccl, which sends CUDA tensors as they are
    host_staged: bool = True


def make_mesh(device="cuda", group=None) -> GopMesh:
    """The mesh of this process on ``device``: its rank in ``group`` (the
    default group when None, which the mesh then names by None) once
    ``torch.distributed`` is initialised, rank 0 of 1 otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a process group was given but "
                             "torch.distributed is not initialised")
        return GopMesh(0, 1, device)
    # the default group stays None here: a mesh that held it would keep
    # it alive past destroy_process_group, to be freed at interpreter
    # exit, where a gloo group's teardown can abort the process
    # ("terminate called without an active exception")
    backend = str(dist.get_backend(group))
    return GopMesh(rank=dist.get_rank(group),
                   size=dist.get_world_size(group), device=device,
                   group=group, host_staged="nccl" not in backend)


def shard_gops(x: np.ndarray, gop_size: int) -> np.ndarray:
    """(G*S+1, ...) frames -> (G, S+1, ...) with duplicated boundaries."""
    P_ = x.shape[0]
    G = (P_ - 1) // gop_size
    idx = np.arange(G)[:, None] * gop_size + np.arange(gop_size + 1)[None, :]
    return np.asarray(x)[idx]


def unshard_gops(x: np.ndarray) -> np.ndarray:
    """(G, k+1, ...) per-GOP frames -> (G*k+1, ...) dropping duplicate
    boundaries (the last frame of GOP g equals the first of GOP g+1)."""
    G, k1 = x.shape[0], x.shape[1]
    head = x[:, :-1].reshape((G * (k1 - 1),) + x.shape[2:])
    return np.concatenate([head, x[-1:, -1]], axis=0)
