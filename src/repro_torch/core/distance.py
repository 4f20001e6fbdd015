"""Distance computations (squared L2 everywhere, as DiskANN does).

``l2_sq`` is the elementwise form the engine's plain path uses (the JAX
package's ``use_kernel=False`` path); ``l2_sq_batch`` is the norm identity
``|q|^2 - 2 q.x + |x|^2`` for dense [Q, N] products (medoid, brute force),
run in full f32 -- callers keep TF32 off (``allow_tf32 = False``).
"""
from __future__ import annotations

import torch

INF = float("inf")
INVALID = -1  # sentinel node id


def l2_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 between broadcastable batches of vectors (last dim)."""
    diff = a.float() - b.float()
    return (diff * diff).sum(-1)


def l2_sq_batch(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[Q, d] x [N, d] -> [Q, N] squared distances via the matmul identity."""
    q = queries.float()
    x = points.float()
    qn = (q * q).sum(-1, keepdim=True)
    xn = (x * x).sum(-1)
    return torch.clamp(qn - 2.0 * (q @ x.T) + xn[None, :], min=0.0)


def gather_l2(query: torch.Tensor, vectors: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """Distances from one query to ``vectors[ids]``; INVALID ids -> +inf."""
    pts = vectors[ids.clamp(min=0).long()]
    d = l2_sq(query[None, :], pts)
    return torch.where(ids >= 0, d, torch.full_like(d, INF))
