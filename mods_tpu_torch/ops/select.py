"""Fixed-size selections with the JAX package's exact semantics.

``lax.top_k`` and ``jnp.nonzero(size=...)`` have no exact counterpart
in PyTorch, and the capped compactions of the main path depend on their
order:

* **Top-k tie order.**  XLA's ``top_k`` breaks ties toward the lower
  index; ``torch.topk`` promises no order on CUDA.  ``top_k`` below is a
  stable descending sort, sliced.
* **Fixed-size nonzero.**  ``jnp.nonzero(size=n, fill_value=0)`` returns
  the first ``n`` indices in scan order, padded with 0.
  ``torch.nonzero`` has a data-dependent length (and syncs the host on
  CUDA).  ``nonzero_static`` keeps the JAX semantics with a prefix sum
  and a scatter, and also returns the validity mask of its slots.
* **Picking by a device index.**  ``a[i]`` with a 0-dim index tensor
  reads ``i`` back to the host (it becomes a Python int); ``pick`` keeps
  the index on the device.
"""

from __future__ import annotations

import torch


def top_k(key: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last
    axis, descending, ties to the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nonzero_static(mask: torch.Tensor, size: int):
    """First ``size`` indices where ``mask`` is set along its last axis,
    in scan order, padded with 0 -> (idx (..., size) int64, valid
    (..., size) bool); leading axes are independent rows (the JAX
    package's ``vmap`` of ``jnp.nonzero(size=...)``)."""
    n = mask.shape[-1]
    lead = mask.shape[:-1]
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), -1) - 1
    sel = mask & (pos < size)
    # slot ``size`` is a discard bin for the unselected entries
    slot = torch.where(sel, pos, torch.full_like(pos, size))
    out = torch.zeros(lead + (size + 1,), dtype=torch.int64, device=dev)
    out.scatter_(-1, slot, torch.arange(n, device=dev).expand_as(slot))
    count = (torch.clamp(pos[..., -1:] + 1, max=size) if n
             else pos.new_zeros(lead + (1,)))
    valid = torch.arange(size, device=dev) < count
    return torch.where(valid, out[..., :size], 0), valid


def pick(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 0-dim integer tensor ``i``, with no host read."""
    return a.index_select(0, i.reshape(1))[0]
