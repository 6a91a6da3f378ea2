"""Content-addressed artifact store: checkpoint/resume of encode work.

Port of ``qsvc_tpu/utils/artifacts.py``.  The reference checkpoints
through the filesystem — every stage intermediate persists and
``motion_estimate`` explicitly SKIPS work when its output file already
exists (motion_estimate.cpp:659-682).  The one-process equivalent is a
content-addressed store over the natural unit of independent work, the
GOP: a per-GOP encoded stream is keyed by the hash of (input frames,
codec parameters), so

* re-running an interrupted encode only encodes the missing GOPs;
* re-encoding an edited sequence only touches the GOPs whose frames
  changed.

The key is the JAX package's for the same chunk and parameters, so a
store written by either package serves the other.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np
import torch

from ..config import CodecConfig
from ..io.yuv import Video


def gop_key(chunk: Video, cfg: CodecConfig, reversible: bool) -> str:
    """Content hash of one GOP's input frames + the encode parameters
    (frames on a device are hashed from a host copy)."""
    h = hashlib.sha256()
    h.update(repr((cfg.pixels_in_x, cfg.pixels_in_y, cfg.TRLs, cfg.SRLs,
                   cfg.auto_block_size, cfg.auto_block_size_min,
                   cfg.border_size, cfg.block_overlaping, cfg.search_range,
                   cfg.subpixel_accuracy, cfg.update_factor, cfg.always_B,
                   cfg.quantization_texture, cfg.quantization_step,
                   cfg.nLayers, cfg.codeblock_size, cfg.texture_coder,
                   cfg.texture_backend, reversible)).encode())
    for plane in chunk.planes():
        if isinstance(plane, torch.Tensor):
            plane = plane.cpu().numpy()
        h.update(np.ascontiguousarray(plane, np.uint8).tobytes())
    return h.hexdigest()


class ArtifactStore:
    """Directory of ``<sha256>.qsvc`` per-GOP streams."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".qsvc")

    def get(self, key: str) -> Optional[bytes]:
        p = self._path(key)
        if os.path.exists(p):
            with open(p, "rb") as f:
                return f.read()
        return None

    def put(self, key: str, data: bytes) -> None:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._path(key))       # atomic: crash-safe resume


def compress_gops_resumable(video: Video, cfg: CodecConfig,
                            store: ArtifactStore,
                            reversible: bool = False,
                            window: int = 2,
                            progress=None, *,
                            device="cuda") -> List[bytes]:
    """Per-GOP encode on ``device`` with checkpoint/resume: GOPs whose
    (frames, params) hash is already in the store are NOT re-encoded; the
    missing ones run through the pipelined ``compress_chunks`` path
    (``window`` GOPs in flight) and are checkpointed as they finish.
    Arbitrary frame counts are allowed (short tail chunk, see
    api.compress_gops).  Returns the ordered per-GOP byte streams (decode
    with :func:`qsvc_tpu_torch.api.expand_gops`).  ``progress(gop_index,
    nbytes, cached)`` is called per finished GOP."""
    from .. import api

    S = cfg.gop_size
    gop_cfg = cfg.replace(GOPs=1)
    G = (max(1, -(-(video.frames - 1) // S)) if cfg.TRLs > 1
         else cfg.GOPs)
    chunks = [video[g * S:(g + 1) * S + 1] for g in range(G)]
    keys = [gop_key(c, gop_cfg, reversible) for c in chunks]
    out: List[Optional[bytes]] = [store.get(k) for k in keys]
    if progress is not None:
        for g, d in enumerate(out):
            if d is not None:
                progress(g, len(d), True)
    missing = [g for g, d in enumerate(out) if d is None]

    def on_finish(i: int, vs) -> None:
        g = missing[i]
        data = vs.to_bytes()
        store.put(keys[g], data)
        out[g] = data
        if progress is not None:
            progress(g, len(data), False)

    api.compress_chunks([chunks[g] for g in missing], gop_cfg,
                        reversible=reversible, window=window,
                        progress=on_finish, device=device)
    return out  # type: ignore[return-value]
