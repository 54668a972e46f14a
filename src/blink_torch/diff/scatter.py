"""Gradient scatter: per-ray gradient rows summed into per-primitive
buckets (counterpart of `blink.diff.scatter`).

Autograd already writes these sums as the backward of refine's gathers;
this module is the explicit form, for callers that accumulate raw per-hit
gradients themselves.
"""
from __future__ import annotations

import torch


def scatter_grads(per_ray: torch.Tensor, prim_id: torch.Tensor, n_prims: int) -> torch.Tensor:
    """Sum per-ray rows (N, ...) into (n_prims, ...) buckets by prim_id (N,).
    Rays whose id lies outside [0, n_prims) are dropped, as
    `jax.ops.segment_sum` drops them (index_add_ would raise on them)."""
    ok = (prim_id >= 0) & (prim_id < n_prims)
    out = torch.zeros((n_prims,) + per_ray.shape[1:], dtype=per_ray.dtype,
                      device=per_ray.device)
    return out.index_add_(0, prim_id[ok].long(), per_ray[ok])


def scatter_grads_masked(per_ray: torch.Tensor, prim_id: torch.Tensor, mask: torch.Tensor,
                         n_prims: int) -> torch.Tensor:
    """scatter_grads with a validity mask: masked-off rays are parked in an
    overflow bucket n_prims, which is cut off."""
    safe_id = torch.where(mask, prim_id, n_prims)
    return scatter_grads(per_ray, safe_id, n_prims + 1)[:n_prims]
