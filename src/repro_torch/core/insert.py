"""Insert (Algorithm 2) -- batched, with the paper's Delta back-edge
structure (PyTorch port of ``core/insert.py``).

A batch of B new points is inserted in three stages:

  1. candidate generation: a beam search per new point against the
     current graph;
  2. RobustPrune over the visited set and final list -> the new point's
     out-neighbours;
  3. back edges: the (target j, source p) pairs are grouped by target, and
     every affected node either appends its new sources (if it stays within
     the degree budget R) or re-prunes N_out(j) + {p...}.

Every prune rides ``prune.robust_prune_batch`` (the ``robust_prune_fp`` or
``robust_prune_sdc`` kernel under ``use_kernel``).  Points inside one batch
do not see each other, as in the reference.

Unlike the JAX package, which scatters into a dense [N, d_max] Delta buffer
and processes ``min(P, N)`` rows (most of them untouched), the port groups
the pairs into rows for the DISTINCT targets only and processes just those:
the rows it writes are the same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .distance import INVALID
from .prune import (FullPrecisionPrune, SDCPrune, prune_node_batch,
                    robust_prune_batch)
from .search import SearchResult, beam_search


class InsertEdges(NamedTuple):
    new_adj: torch.Tensor   # [B, R] out-neighbours of the new points
    pairs_j: torch.Tensor   # [B*R] back-edge targets (INVALID padded)
    pairs_p: torch.Tensor   # [B*R] back-edge sources
    search: SearchResult


def compute_insert_edges(adjacency, navigable, usable, start, prune_table,
                         new_slots, new_vecs, backend, *, L: int,
                         max_visits: int, alpha: float, R: int,
                         beam_width: int = 1, use_kernel: bool = False
                         ) -> InsertEdges:
    """Stages 1+2: search & prune.  The graph is pre-insert (the new points
    are stored but have no in-edges, so searches cannot reach them)."""
    res = beam_search(adjacency, navigable, start, new_vecs, backend,
                      L=L, max_visits=max_visits, beam_width=beam_width,
                      use_kernel=use_kernel)
    # Candidate pool: V union the final list.
    cand = torch.cat([res.visited, res.ids], 1)                 # [B, V+L]
    safe = cand.clamp(min=0).long()
    ok = (cand >= 0) & usable[safe] & (cand != new_slots[:, None])
    pb = FullPrecisionPrune(prune_table)
    d_p = pb.anchor_dists(new_vecs.float(), cand)
    new_adj = robust_prune_batch(pb, cand, ok, alpha=alpha, R=R,
                                 use_kernel=use_kernel, d_p=d_p).ids
    B = new_slots.shape[0]
    pairs_j = new_adj.reshape(B * R)
    pairs_p = new_slots[:, None].expand(B, R).reshape(B * R).to(torch.int32)
    pairs_p = torch.where(pairs_j >= 0, pairs_p,
                          torch.full_like(pairs_p, INVALID))
    return InsertEdges(new_adj, pairs_j, pairs_p, res)


def group_pairs(pairs_j: torch.Tensor, pairs_p: torch.Tensor, d_max: int):
    """Group back-edge pairs by target.

    Returns (targets [A] ascending distinct valid targets, buf [A, d_max]
    their sources in pair order, INVALID padded, overflow beyond d_max
    dropped; counts [A] all sources, uncapped) -- the rows ``targets`` of
    the reference's dense (buf [N, d_max], counts [N]).
    """
    dev = pairs_j.device
    valid = pairs_j >= 0
    sj = pairs_j[valid].long()
    sp = pairs_p[valid]
    order = torch.sort(sj, stable=True).indices
    sj, sp = sj[order], sp[order]
    targets, counts = torch.unique_consecutive(sj, return_counts=True)
    first = torch.cumsum(counts, 0) - counts                   # group starts
    grp = torch.repeat_interleave(torch.arange(len(targets), device=dev),
                                  counts)
    slot = torch.arange(len(sj), device=dev) - first[grp]
    keep = slot < d_max
    buf = torch.full((len(targets), d_max), INVALID, dtype=torch.int32,
                     device=dev)
    buf[grp[keep], slot[keep]] = sp[keep].to(torch.int32)
    return targets, buf, counts.to(torch.int32)


def _dedupe_combine(combine: torch.Tensor) -> torch.Tensor:
    """Mask later duplicates to INVALID, keeping the first occurrence (a
    source already in N_out(j), or listed twice, is not appended twice)."""
    Ct = combine.shape[-1]
    earlier = torch.tril(torch.ones((Ct, Ct), dtype=torch.bool,
                                    device=combine.device), diagonal=-1)
    eq = combine[..., :, None] == combine[..., None, :]        # [.., i, j]
    dup = (eq & earlier).any(-1) & (combine >= 0)
    return torch.where(dup, torch.full_like(combine, INVALID), combine)


def patch_delta(adjacency: torch.Tensor, backend, usable: torch.Tensor,
                pairs_j: torch.Tensor, pairs_p: torch.Tensor, *, alpha: float,
                R: int, d_max: int | None = None, chunk: int = 1024,
                use_kernel: bool = False,
                affected_cap: int | None = None) -> tuple[torch.Tensor, int]:
    """Stage 3 / the StreamingMerge Patch phase: apply Delta through a
    prune backend.  Each affected node appends its new sources, or
    re-prunes N_out(j) + sources when they exceed R (Algorithm 2).

    Updates ``adjacency`` in place, the rows of the distinct targets in
    ascending order, ``chunk`` rows at a time, and returns it with the
    number of rows sent to the prune engine.  At most ``affected_cap``
    targets are processed, the lowest first, as the reference's top-k over
    the affected indicator takes them (callers pass a cap no smaller than
    the distinct-target count; None is the worst case min(P, N)).
    """
    d_max = d_max if d_max is not None else R
    targets, buf, _ = group_pairs(pairs_j, pairs_p, d_max)
    a_max = min(pairs_j.shape[0], adjacency.shape[0])
    if affected_cap is not None:
        a_max = max(1, min(a_max, int(affected_cap)))
    targets, buf = targets[:a_max], buf[:a_max]
    n_pruned = 0
    for lo in range(0, len(targets), chunk):
        js = targets[lo:lo + chunk]
        combine = _dedupe_combine(torch.cat([adjacency[js],
                                             buf[lo:lo + chunk]], 1))
        valid = combine >= 0
        total = valid.sum(1)
        app_order = torch.sort((~valid).to(torch.int8), dim=1,
                               stable=True).indices
        rows = combine.gather(1, app_order)[:, :R]
        over = (total > R).nonzero()[:, 0]
        if len(over):
            rows[over] = prune_node_batch(
                backend, js[over].to(torch.int32), combine[over], usable,
                alpha=alpha, R=R, use_kernel=use_kernel).ids
            n_pruned += len(over)
        adjacency[js] = rows
    return adjacency, n_pruned


def apply_back_edges(adjacency: torch.Tensor, prune_table: torch.Tensor,
                     usable: torch.Tensor, pairs_j: torch.Tensor,
                     pairs_p: torch.Tensor, *, alpha: float, R: int,
                     d_max: int | None = None, chunk: int = 1024,
                     use_kernel: bool = False,
                     affected_cap: int | None = None) -> torch.Tensor:
    """Stage 3 with full-precision prune distances from ``prune_table``
    (``patch_delta``); updates ``adjacency`` in place and returns it."""
    return patch_delta(adjacency, FullPrecisionPrune(prune_table), usable,
                       pairs_j, pairs_p, alpha=alpha, R=R, d_max=d_max,
                       chunk=chunk, use_kernel=use_kernel,
                       affected_cap=affected_cap)[0]


def apply_back_edges_codes(adjacency: torch.Tensor, codes: torch.Tensor,
                           tables: torch.Tensor, usable: torch.Tensor,
                           pairs_j: torch.Tensor, pairs_p: torch.Tensor, *,
                           alpha: float, R: int, d_max: int | None = None,
                           chunk: int = 1024, use_kernel: bool = False,
                           affected_cap: int | None = None) -> torch.Tensor:
    """The Patch phase with SDC distances from PQ ``codes`` [N, m] and
    ``tables`` [m, ksub, ksub] (``patch_delta``)."""
    return patch_delta(adjacency, SDCPrune(codes, tables), usable, pairs_j,
                       pairs_p, alpha=alpha, R=R, d_max=d_max, chunk=chunk,
                       use_kernel=use_kernel, affected_cap=affected_cap)[0]
