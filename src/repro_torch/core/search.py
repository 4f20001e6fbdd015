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
fetched.  For an in-memory source every expanded row is a fetch, so
``n_reads`` is the visit count.  A disk-backed source
(``repro_torch.storage.DiskSource``) reports a per-row ``fetched`` mask
instead: rows its block cache served are not reads (they are counted as
``SystemStats.io_cache_hits``), rows the prefetcher read ahead still are;
with the cache off, disk ``n_reads`` equals the dense count.

Graph rows come through a ``GraphSource`` (``rows``, ``node_ok``):
``DenseSource`` over device tensors by default, ``storage.HBMSource``
through the ``gather_rows`` kernel, or ``storage.DiskSource`` off the
on-disk layout.  A source with the hinted extension (``rows_hinted`` and
``hint_width``) also receives each round's lookahead hint (``_lookahead``)
so that a prefetcher can stage the next round's rows.

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

from typing import NamedTuple, Optional, Protocol

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


class GraphSource(Protocol):
    """Adjacency and navigability access for the engine.

    A source may also implement the hinted extension: ``rows_hinted(ids,
    hints) -> (rows, fetched)`` and an integer ``hint_width``.  Its
    presence routes the engine onto the frontier -> prefetch handshake:
    each round hands the source its frontier and the next ``hint_width``
    open candidates, and ``n_reads`` sums the returned ``fetched`` masks.
    """

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [B, W] int32 -> adjacency rows [B, W, R]; INVALID rows for
        ids < 0."""
        ...

    def node_ok(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [B, K] int32 -> bool [B, K]: valid (>= 0) and navigable."""
        ...


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


def _lookahead(cand_ids: torch.Tensor, cand_d: torch.Tensor,
               vis_ids: torch.Tensor, hint_w: int) -> torch.Tensor:
    """The engine half of the frontier -> prefetch handshake: after a
    ``frontier_select`` the list is sorted and the frontier is already
    visited, so the first ``hint_w`` entries of each row that are valid,
    unvisited and finite are the nodes the next frontier is drawn from
    (unless a fresh discovery outranks them).  [B, L] -> [B, min(hint_w,
    L)], INVALID-padded; a pure function of the loop state."""
    B, L = cand_ids.shape
    if hint_w <= 0:
        return torch.full((B, 0), INVALID, dtype=torch.int32,
                          device=cand_ids.device)
    in_vis = (cand_ids[:, :, None] == vis_ids[:, None, :]).any(2)
    open_ = (cand_ids >= 0) & ~in_vis & torch.isfinite(cand_d)
    # Open entries first, in list (= distance) order.
    key = torch.where(open_, torch.arange(L, dtype=torch.int32,
                                          device=cand_ids.device), L)
    order = torch.sort(key, dim=1, stable=True).indices[:, :hint_w]
    return torch.where(open_.gather(1, order), cand_ids.gather(1, order),
                       torch.full_like(cand_ids[:, :1], INVALID))


def beam_search(adjacency: Optional[torch.Tensor],
                navigable: Optional[torch.Tensor],
                start: torch.Tensor, queries: torch.Tensor, backend, *,
                L: int, max_visits: int, beam_width: int = 1,
                use_kernel: bool = False,
                base: Optional[torch.Tensor] = None,
                source: Optional[GraphSource] = None,
                R: Optional[int] = None) -> SearchResult:
    """Batched beam-width Algorithm 1 over ``queries`` [B, ...].

    ``start`` is a scalar entry point or one per row [B] (row-local id).
    ``base`` [B] offsets each row's ids into ``adjacency``/``navigable``
    and the backend's table (None: one graph for every row).  ``source``
    replaces the dense row access (a source without device-resident
    topology, ``storage.DiskSource``, comes with ``adjacency=None`` and an
    explicit ``R``).
    """
    if beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    if R is None:
        R = adjacency.shape[1]
    W = min(beam_width, L)
    K = W * R
    B = queries.shape[0]
    dev = queries.device
    src = DenseSource(adjacency, navigable) if source is None else source
    hinted = hasattr(src, "rows_hinted")
    hint_w = int(getattr(src, "hint_width", 0)) if hinted else 0
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
    if hinted:
        n_reads = torch.zeros(B, dtype=i32, device=dev)
        hint = _lookahead(state[0], state[1], state[4], hint_w)
    earlier = (torch.tril(torch.ones((K, K), dtype=torch.bool, device=dev),
                          diagonal=-1) if W > 1 else None)

    while True:
        cand_ids, cand_d, f_ids, f_d, vis_ids, vis_d, vis_cnt = state
        live = (f_ids >= 0).any(1)              # rows with a frontier
        if not bool(live.any()):
            break
        # One-shot W x R adjacency gather (one IO round).  Finished rows
        # hand the source their frozen (all-INVALID) frontier and frozen
        # hint, as the lanes of a vmapped while_loop do.
        if hinted:
            frows, fetched = src.rows_hinted(globalize(f_ids, base),
                                             globalize(hint, base))
            nbrs = frows.reshape(B, K)
        else:
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
        if hinted:
            n_reads = n_reads + torch.where(live, fetched.sum(1, dtype=i32),
                                            0)
            hint = torch.where(live[:, None], _lookahead(
                nxt[0], nxt[1], nxt[4], hint_w), hint)

    cand_ids, cand_d, _, _, vis_ids, vis_d, vis_cnt = state
    # Dense sources fetch every visited row; hinted ones counted fetches.
    return SearchResult(cand_ids, cand_d, vis_ids, vis_d, n_hops, n_cmps,
                        n_reads if hinted else vis_cnt)


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
