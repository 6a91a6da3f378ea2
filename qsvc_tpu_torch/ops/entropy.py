"""Shannon entropy of a 256-bin histogram (reference entropy.cpp:19-33).

Port of ``qsvc_tpu/ops/entropy.py``.  Drives the adaptive I/B frame
decision; the ``p*log2(p)`` sum stays float32 like the reference's
``float`` accumulation.  Values outside ``[0, bins)`` are not counted,
as in the JAX version.
"""

from __future__ import annotations

import torch


def histogram_entropy(values: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Entropy (bits/symbol) of the histogram of all of ``values``, a 0-dim
    float32 tensor (the JAX function's contract)."""
    return histogram_entropy_rows(values.reshape(1, -1), bins)[0]


def histogram_entropy_rows(values: torch.Tensor, bins: int = 256
                           ) -> torch.Tensor:
    """Entropy (bits/symbol) of the histogram of each row of ``values``.

    ``values``: (N, ...) integers; returns (N,) float32, one entropy per
    leading index (``jax.vmap`` of :func:`histogram_entropy`).
    """
    n = values.shape[0]
    flat = values.reshape(n, -1).to(torch.int64)
    # out-of-range values go to a spill bin that is dropped below
    flat = torch.where((flat >= 0) & (flat < bins), flat, bins)
    rows = torch.arange(n, device=flat.device)[:, None] * (bins + 1)
    # a scatter-add, not bincount: bincount reads its input's maximum
    # back to the host on CUDA, which no CUDA graph capture allows
    index = (flat + rows).reshape(-1)
    count = torch.zeros(n * (bins + 1), dtype=torch.int32,
                        device=flat.device).index_add_(
        0, index, torch.ones_like(index, dtype=torch.int32))
    count = count.reshape(n, bins + 1)[:, :bins]
    total = count.sum(dim=1, keepdim=True)
    p = count.to(torch.float32) / total.to(torch.float32)
    terms = torch.where(count > 0, p * torch.log2(p), 0.0)
    return -terms.sum(dim=1)
