r"""Beam-width GreedySearch (Algorithm 1), batched over query rows.

The PyTorch counterpart of the JAX package's ``core/search.py``.  The JAX
engine vmaps a per-query ``while_loop``; here the query rows form an
explicit batch and one Python loop runs while any row still has a
frontier.  A row whose frontier is empty is frozen -- its lists and its
counters no longer change -- exactly as a finished lane is under ``vmap``.

Each round gathers the frontier's W x R adjacency rows (one IO round),
marks the fresh neighbours (navigable, not already listed or visited, the
first copy across the W rows), scores them with ONE batched distance call,
and runs ONE ``frontier_select`` step that merges them into the candidate
list, picks the next frontier and appends it to the visited set.

Counters per row, as in the reference: ``n_hops`` IO rounds, ``n_cmps``
distance computations against fresh neighbours, ``n_reads`` adjacency rows
fetched (the visit count, every row being an in-memory fetch).

Several graphs can be searched as one batch: their tensors are
concatenated into one table and each query row carries a ``base`` offset
into it (``index.search_lanes`` stacks the temp tiers this way).  Node ids
in the search state stay local to each row's graph.

Distances go through a backend: ``FullPrecisionBackend`` (exact L2; the
``l2_rows`` kernel when ``use_kernel``) or ``PQBackend`` (ADC over PQ
codes; the ``adc_rows`` kernel when ``use_kernel``).  Without
``use_kernel`` both run the plain engine path of the JAX package's
``use_kernel=False`` engine, which is the CPU path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import pq as pqm
from .distance import INVALID, l2_sq
from ..kernels import ops


def globalize(ids: torch.Tensor, base: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """Row-local node ids -> ids into the concatenated table (rows offset by
    ``base`` [B]); INVALID stays INVALID."""
    if base is None:
        return ids
    return torch.where(ids >= 0, ids + base[:, None], ids)


class FullPrecisionBackend(NamedTuple):
    """Exact squared L2 against stored full-precision vectors."""

    vectors: torch.Tensor            # [N, d]

    def prepare(self, queries: torch.Tensor) -> torch.Tensor:
        return queries.float().contiguous()

    def distances(self, ctx: torch.Tensor, ids: torch.Tensor, *,
                  use_kernel: bool = False) -> torch.Tensor:
        """ids [B, K] int32 (INVALID-padded) -> [B, K] f32 (+inf)."""
        if use_kernel:
            return ops.l2_rows(ctx, self.vectors, ids.contiguous())
        pts = self.vectors[ids.clamp(min=0).long()]          # [B, K, d]
        d = l2_sq(ctx[:, None, :], pts)
        return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


class PQBackend(NamedTuple):
    """Asymmetric distance computation over PQ codes (LTI navigation)."""

    codes: torch.Tensor              # [N, m] uint8
    codebook: pqm.PQCodebook

    def prepare(self, queries: torch.Tensor) -> torch.Tensor:
        return pqm.lut(self.codebook, queries).contiguous()  # [B, m, ksub]

    def distances(self, ctx: torch.Tensor, ids: torch.Tensor, *,
                  use_kernel: bool = False) -> torch.Tensor:
        if use_kernel:
            return ops.adc_rows(ctx, self.codes, ids.contiguous())
        return pqm.adc_gather(self.codes, ctx, ids)


class DenseSource(NamedTuple):
    """Dense adjacency/navigability access (ids into the whole table)."""

    adjacency: torch.Tensor          # [N, R] int32
    navigable: torch.Tensor          # [N] bool

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [B, W] -> adjacency rows [B, W, R]; INVALID rows for ids<0."""
        r = self.adjacency[ids.clamp(min=0).long()]
        return torch.where((ids >= 0)[..., None], r, torch.full_like(
            r, INVALID))

    def node_ok(self, ids: torch.Tensor) -> torch.Tensor:
        return (ids >= 0) & self.navigable[ids.clamp(min=0).long()]


def batch_distances(backend, queries: torch.Tensor, ids: torch.Tensor, *,
                    use_kernel: bool = False) -> torch.Tensor:
    """[B, ...] queries x [B, K] ids -> [B, K] distances (exact rerank)."""
    return backend.distances(backend.prepare(queries), ids,
                             use_kernel=use_kernel)


class SearchResult(NamedTuple):
    ids: torch.Tensor            # [B, L] final candidate list (sorted)
    dists: torch.Tensor          # [B, L]
    visited: torch.Tensor        # [B, V] expanded nodes in expansion order
    visited_dists: torch.Tensor  # [B, V]
    n_hops: torch.Tensor         # [B] IO rounds
    n_cmps: torch.Tensor         # [B] distance computations
    n_reads: torch.Tensor        # [B] adjacency rows fetched


def beam_search(adjacency: torch.Tensor, navigable: torch.Tensor,
                start: torch.Tensor, queries: torch.Tensor, backend, *,
                L: int, max_visits: int, beam_width: int = 1,
                use_kernel: bool = False,
                base: Optional[torch.Tensor] = None) -> SearchResult:
    """Batched beam-width Algorithm 1 over ``queries`` [B, ...].

    ``start`` is a scalar entry point or one per row [B] (row-local id).
    ``base`` [B] offsets each row's ids into ``adjacency``/``navigable``
    and the backend's table (None: one graph for every row).
    """
    if beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    R = adjacency.shape[1]
    W = min(beam_width, L)
    K = W * R
    B = queries.shape[0]
    dev = adjacency.device
    src = DenseSource(adjacency, navigable)
    ctx = backend.prepare(queries)
    i32 = torch.int32
    inf = float("inf")

    starts = torch.as_tensor(start, device=dev).to(i32).expand(B)
    cand_ids = torch.full((B, L), INVALID, dtype=i32, device=dev)
    cand_ids[:, 0] = starts
    d0 = backend.distances(ctx, globalize(cand_ids[:, :1].contiguous(), base),
                           use_kernel=use_kernel)[:, 0]
    cand_d = torch.full((B, L), inf, device=dev)
    cand_d[:, 0] = d0
    vis_ids = torch.full((B, max_visits), INVALID, dtype=i32, device=dev)
    vis_d = torch.full((B, max_visits), inf, device=dev)
    vis_cnt = torch.zeros(B, dtype=i32, device=dev)

    def step(cand_ids, cand_d, new_ids, new_d, vis_ids, vis_d, vis_cnt):
        return ops.frontier_select(cand_ids, cand_d, new_ids, new_d,
                                   vis_ids, vis_d, vis_cnt, W=W,
                                   max_visits=max_visits,
                                   use_kernel=use_kernel)

    # Round 0: no fresh neighbours; the step picks the start node.
    state = step(cand_ids, cand_d,
                 torch.full((B, K), INVALID, dtype=i32, device=dev),
                 torch.full((B, K), inf, device=dev), vis_ids, vis_d,
                 vis_cnt)
    n_cmps = torch.zeros(B, dtype=i32, device=dev)
    n_hops = torch.zeros(B, dtype=i32, device=dev)
    earlier = (torch.tril(torch.ones((K, K), dtype=torch.bool, device=dev),
                          diagonal=-1) if W > 1 else None)

    while True:
        cand_ids, cand_d, f_ids, f_d, vis_ids, vis_d, vis_cnt = state
        live = (f_ids >= 0).any(1)              # rows with a frontier
        if not bool(live.any()):
            break
        # One-shot W x R adjacency gather (one IO round).
        nbrs = src.rows(globalize(f_ids, base)).reshape(B, K)
        ok = src.node_ok(globalize(nbrs, base))
        in_list = (nbrs[:, :, None] == cand_ids[:, None, :]).any(2)
        in_vis = (nbrs[:, :, None] == vis_ids[:, None, :]).any(2)
        new = ok & ~in_list & ~in_vis
        if earlier is not None:
            # Frontier rows share neighbours: keep the first copy only.
            dup = ((nbrs[:, :, None] == nbrs[:, None, :])
                   & earlier[None]).any(2)
            new = new & ~dup
        new_ids = torch.where(new, nbrs, torch.full_like(nbrs, INVALID))
        new_d = backend.distances(ctx, globalize(new_ids, base),
                                  use_kernel=use_kernel)
        nxt = step(cand_ids, cand_d, new_ids, new_d, vis_ids, vis_d,
                   vis_cnt)
        # Finished rows stay frozen, as lanes of a vmapped while_loop.
        state = tuple(torch.where(live.view(-1, *([1] * (a.dim() - 1))),
                                  a, b) for a, b in zip(nxt, state))
        n_cmps = n_cmps + torch.where(live, new.sum(1, dtype=i32), 0)
        n_hops = n_hops + live.to(i32)

    cand_ids, cand_d, _, _, vis_ids, vis_d, vis_cnt = state
    return SearchResult(cand_ids, cand_d, vis_ids, vis_d, n_hops, n_cmps,
                        vis_cnt)


def rerank_candidates(ids: torch.Tensor, reportable: torch.Tensor
                      ) -> torch.Tensor:
    """Mask non-reportable candidates to INVALID before the exact rerank
    gather (they can never be reported; their rows need not be read)."""
    keep = (ids >= 0) & reportable[ids.clamp(min=0).long()]
    return torch.where(keep, ids, torch.full_like(ids, INVALID))


def topk_results(res: SearchResult, k: int, reportable: torch.Tensor):
    """Final top-k, excluding DeleteList/inactive nodes (paper §5.2)."""
    ok = (res.ids >= 0) & reportable[res.ids.clamp(min=0).long()]
    return topk_masked(res.ids, res.dists, ok, k)


def topk_masked(ids: torch.Tensor, dists: torch.Tensor, ok: torch.Tensor,
                k: int):
    """Top-k of the ``ok`` entries of each row (stable on ties), with
    (INVALID, +inf) where fewer than k are finite."""
    d = torch.where(ok, dists, torch.full_like(dists, float("inf")))
    order = torch.sort(d, dim=-1, stable=True).indices[:, :k]
    out_ids = ids.gather(1, order)
    out_d = d.gather(1, order)
    out_ids = torch.where(torch.isfinite(out_d), out_ids,
                          torch.full_like(out_ids, INVALID))
    return out_ids, out_d
