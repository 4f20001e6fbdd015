"""Locality-aware update batching: proximity-order a batch before it hits
the graph (PyTorch port of ``core/locality.py``).

Points processed in proximity order collide onto the same graph rows: a
flush chunk's beam searches expand overlapping frontiers, its back edges
hit fewer distinct targets, and a merge's back edges concentrate on the
just-inserted cluster mates.  ``locality_order`` is the ordering: a seeded
sampled-medoid sort, deterministic for a fixed ``(vecs, valid, seed)``,
and a true permutation.  Consumers: the system's flush and
``merge.streaming_merge(..., locality=True)``, behind
``SystemConfig.locality_order``.

The reference draws its medoids with ``jax.random.choice``, whose bits the
port cannot reproduce.  So the port splits the function in two: a draw
(``draw_medoids``, a CPU ``torch.Generator``, so the CPU and the card take
the same medoids) and the ordering proper (``order_by_medoids``), which
takes medoid indices; given the reference's indices it gives the
reference's permutation.
"""
from __future__ import annotations

from typing import Optional

import torch


def draw_medoids(valid: torch.Tensor, n_clusters: int = 16,
                 seed: int = 0) -> torch.Tensor:
    """``min(n_clusters, B)`` medoid row indices [k] int64 (on the CPU),
    drawn with replacement, biased to valid rows (an invalid row keeps a
    tiny weight, so the draw is defined when nothing is valid)."""
    B = valid.shape[0]
    k = max(1, min(n_clusters, B))
    w = torch.where(valid.cpu(), 1.0, 1e-9).double()
    g = torch.Generator().manual_seed(int(seed))
    return torch.multinomial(w, k, replacement=True, generator=g)


def order_by_medoids(vecs: torch.Tensor, valid: torch.Tensor,
                     medoids: torch.Tensor) -> torch.Tensor:
    """The permutation [B] int32 sorting rows by (nearest medoid, distance
    to it, original index); invalid rows last in original order."""
    v = vecs.float()
    med = v[medoids.to(v.device).long()]                    # [k, d]
    k = med.shape[0]
    d = ((v[:, None, :] - med[None, :, :]) ** 2).sum(-1)      # [B, k]
    cl = torch.argmin(d, dim=1)
    dc = d.gather(1, cl[:, None])[:, 0]
    cl = torch.where(valid, cl, torch.full_like(cl, k))
    dc = torch.where(valid, dc, torch.full_like(dc, float("inf")))
    # Two stable sorts == lexsort by (cluster, distance, original index).
    order = torch.sort(dc, stable=True).indices
    perm = order[torch.sort(cl[order], stable=True).indices]
    return perm.to(torch.int32)


def locality_order(vecs: torch.Tensor, valid: Optional[torch.Tensor] = None,
                   *, n_clusters: int = 16, seed: int = 0,
                   medoids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Proximity-ordering permutation over a batch of vectors [B, d]:
    ``order_by_medoids`` with ``medoids`` (default: ``draw_medoids`` from
    ``seed``)."""
    if valid is None:
        valid = torch.ones(vecs.shape[0], dtype=torch.bool,
                           device=vecs.device)
    if medoids is None:
        medoids = draw_medoids(valid, n_clusters, seed)
    return order_by_medoids(vecs, valid, medoids)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """``inv`` with ``inv[perm[i]] == i``."""
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                    device=perm.device)
    return inv


def cluster_spans(perm: torch.Tensor, vecs: torch.Tensor,
                  valid: torch.Tensor, *, n_clusters: int = 16,
                  seed: int = 0,
                  medoids: Optional[torch.Tensor] = None) -> int:
    """Cluster transitions along the ordered batch (lower is better; a
    perfect ordering has at most ``n_clusters - 1`` over the valid rows)."""
    if medoids is None:
        medoids = draw_medoids(valid, n_clusters, seed)
    v = vecs.float()
    d = ((v[:, None, :] - v[medoids.to(v.device).long()][None]) ** 2).sum(-1)
    p = perm.long()
    cl = torch.argmin(d, dim=1)[p][valid[p]]
    return int((cl[1:] != cl[:-1]).sum()) if len(cl) > 1 else 0


def next_bucket(n: int, *, floor: int = 16, cap: int | None = None) -> int:
    """Round a row count up to a power-of-two launch bucket (at least
    ``floor``, at most ``cap``); 0 for n <= 0."""
    if n <= 0:
        return 0
    b = max(floor, 1 << (n - 1).bit_length())
    return min(b, cap) if cap is not None else b
