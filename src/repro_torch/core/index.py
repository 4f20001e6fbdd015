"""FreshVamana -- the in-memory index (paper §4): build, insert, search, and
the §5.2 query fan-out (PyTorch port of ``core/index.py``).

The JAX package is functional; here ``insert``/``insert_edges_stage``/
``insert_apply_delta`` update the state's tensors IN PLACE (a 2M-slot LTI
build would otherwise copy its 1 GB of vectors and 0.5 GB of adjacency for
every batch) and return the state with its new scalars.  A caller that
needs the old state must clone it first.

``unified_search`` is the one-call fan-out: the temp tiers and the
PQ-navigated LTI lane are beam-searched, the LTI lane exact-reranked, each
lane's slots mapped to external ids with the DeleteList dropped, and the
lanes merged to the global top-k, all on the device.  The temp lanes run as
ONE beam search over (lanes x queries) rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import pq as pqm
from .config import IndexConfig
from .distance import INVALID, l2_sq_batch
from .graph import GraphState, LaneStack, empty_graph, medoid
from .insert import apply_back_edges, compute_insert_edges
from .search import (FullPrecisionBackend, PQBackend, SearchResult,
                     batch_distances, beam_search, globalize,
                     rerank_candidates, topk_masked, topk_results)


def insert_edges_stage(state: GraphState, slots: torch.Tensor,
                       vecs: torch.Tensor, cfg: IndexConfig,
                       L: Optional[int] = None):
    """Stages 1+2 of ``insert``: store the batch, search + prune its
    out-edges, write the new rows, and return (state, pairs_j, pairs_p) --
    the Delta pair list not yet applied.  ``slots`` [B] int32 may hold
    INVALID (masked lanes)."""
    L = L or cfg.L_build
    dev = state.device
    use_kernel = cfg.kernel_enabled(dev)
    valid = slots >= 0
    vs = slots[valid].long()
    state.vectors[vs] = vecs[valid].to(state.vectors.dtype)
    state.active[vs] = True
    state.deleted[vs] = False
    # Re-seed the entry point when it is the empty sentinel: the first valid
    # inserted slot becomes the start.
    first_valid = torch.where(valid.any(), slots[valid.int().argmax()],
                              state.start)
    start = torch.where(state.start < 0, first_valid, state.start).to(
        torch.int32)
    n_total = torch.maximum(state.n_total,
                            torch.where(valid, slots, -1).max() + 1).to(
        torch.int32)
    st = state._replace(start=start, n_total=n_total)
    usable = st.active & ~st.deleted
    edges = compute_insert_edges(
        st.adjacency, st.active, usable, st.start, st.vectors,
        torch.where(valid, slots, INVALID), vecs,
        FullPrecisionBackend(st.vectors),
        L=L, max_visits=cfg.visits_bound(L), alpha=cfg.alpha, R=cfg.R,
        beam_width=cfg.beam_width, use_kernel=use_kernel)
    new_adj = torch.where(valid[:, None], edges.new_adj,
                          torch.full_like(edges.new_adj, INVALID))
    st.adjacency[vs] = new_adj[valid]
    return st, new_adj.reshape(-1), edges.pairs_p


def insert_apply_delta(state: GraphState, pairs_j: torch.Tensor,
                       pairs_p: torch.Tensor, cfg: IndexConfig
                       ) -> GraphState:
    """Stage 3 of ``insert``: apply the staged Delta pair list."""
    usable = state.active & ~state.deleted
    apply_back_edges(state.adjacency, state.vectors, usable, pairs_j,
                     pairs_p, alpha=cfg.alpha, R=cfg.R,
                     use_kernel=cfg.kernel_enabled(state.device))
    return state


def insert(state: GraphState, slots: torch.Tensor, vecs: torch.Tensor,
           cfg: IndexConfig, L: Optional[int] = None) -> GraphState:
    """Insert a batch (Algorithm 2): ``insert_edges_stage`` then
    ``insert_apply_delta``."""
    st, pj, pp = insert_edges_stage(state, slots, vecs, cfg, L)
    return insert_apply_delta(st, pj, pp, cfg)


def _search_graph(state: GraphState, queries: torch.Tensor,
                  cfg: IndexConfig, *, L: int,
                  beam_width: Optional[int]) -> SearchResult:
    return beam_search(state.adjacency, state.active, state.start, queries,
                       FullPrecisionBackend(state.vectors),
                       L=L, max_visits=cfg.visits_bound(L),
                       beam_width=beam_width or cfg.beam_width,
                       use_kernel=cfg.kernel_enabled(state.device))


def search(state: GraphState, queries: torch.Tensor, cfg: IndexConfig, *,
           k: int, L: int, beam_width: Optional[int] = None):
    """Batched search; returns (ids [B,k], dists [B,k], hops [B],
    cmps [B])."""
    res = _search_graph(state, queries, cfg, L=L, beam_width=beam_width)
    ids, d = topk_results(res, k, state.active & ~state.deleted)
    return ids, d, res.n_hops, res.n_cmps


def _search_stacked(states: GraphState, queries: torch.Tensor,
                    cfg: IndexConfig, *, k: int, L: int,
                    beam_width: Optional[int]):
    """All T stacked graphs ([T, ...] tensors) x B queries as ONE beam
    search over T*B rows; results [T, B, ...]."""
    T, cap = states.active.shape
    B = queries.shape[0]
    dev = states.active.device
    base = (torch.arange(T, device=dev, dtype=torch.int32) * cap
            ).repeat_interleave(B)
    res = beam_search(states.adjacency.reshape(T * cap, -1),
                      states.active.reshape(-1),
                      states.start.repeat_interleave(B),
                      queries.repeat(T, 1),
                      FullPrecisionBackend(states.vectors.reshape(
                          T * cap, -1)),
                      L=L, max_visits=cfg.visits_bound(L),
                      beam_width=beam_width or cfg.beam_width,
                      use_kernel=cfg.kernel_enabled(dev), base=base)
    reportable = (states.active & ~states.deleted).reshape(-1)
    ok = (res.ids >= 0) & reportable[globalize(res.ids, base).clamp(
        min=0).long()]
    ids, d = topk_masked(res.ids, res.dists, ok, k)
    return tuple(x.reshape(T, B, *x.shape[1:])
                 for x in (ids, d, res.n_hops, res.n_cmps))


def search_tiers(states: GraphState, queries: torch.Tensor,
                 cfg: IndexConfig, *, k: int, L: int,
                 beam_width: Optional[int] = None):
    """Multi-tier fan-out over T stacked graphs (``graph.stack_graphs``):
    (ids [T,B,k], dists [T,B,k], hops [T,B], cmps [T,B]), lane t equal to
    ``search`` on tier t alone."""
    return _search_stacked(states, queries, cfg, k=k, L=L,
                           beam_width=beam_width)


def search_lanes(stack: LaneStack, queries: torch.Tensor, cfg: IndexConfig,
                 *, k: int, L: int, beam_width: Optional[int] = None,
                 rerank: bool = True):
    """Every lane of ``stack``: the temp group as one exact-L2 beam search
    over (lanes x queries) rows, the LTI lane on PQ ADC at its own
    capacity (exact-reranked with ``rerank``, DeleteList members masked
    before the gather).  Returns (ids, dists [T,B,k], hops, cmps [T,B]),
    the LTI last."""
    outs = []
    if stack.temps is not None:
        outs.append(_search_stacked(stack.temps, queries, cfg, k=k, L=L,
                                    beam_width=beam_width))
    if stack.lti is not None:
        g = stack.lti
        use_kernel = cfg.kernel_enabled(g.device)
        res = beam_search(g.adjacency, g.active, g.start, queries,
                          PQBackend(stack.codes,
                                    pqm.PQCodebook(stack.codebook)),
                          L=L, max_visits=cfg.visits_bound(L),
                          beam_width=beam_width or cfg.beam_width,
                          use_kernel=use_kernel)
        reportable = g.active & ~g.deleted
        if rerank:
            exact = batch_distances(
                FullPrecisionBackend(g.vectors), queries,
                rerank_candidates(res.ids, reportable),
                use_kernel=use_kernel)
            res = res._replace(dists=exact)
        ids, d = topk_results(res, k, reportable)
        outs.append(tuple(x[None] for x in (ids, d, res.n_hops,
                                            res.n_cmps)))
    if not outs:
        raise ValueError("search_lanes: empty LaneStack")
    return tuple(torch.cat(parts, 0) for parts in zip(*outs))


def lanes_to_ext(tables: torch.Tensor, drop: torch.Tensor,
                 slot_ids: torch.Tensor, dists: torch.Tensor):
    """Slot -> external id per lane, DeleteList members inf'd out.

    tables [G, cap] int32/int64, drop [G, cap] bool, slot_ids/dists
    [G, B, C] -> (ext [G, B, C], dists [G, B, C])."""
    G, B, C = slot_ids.shape
    s = slot_ids.clamp(min=0).long().reshape(G, B * C)
    ext = torch.where(slot_ids >= 0,
                      tables.gather(1, s).reshape(G, B, C),
                      torch.full((), -1, dtype=tables.dtype,
                                 device=tables.device))
    dead = (slot_ids >= 0) & drop.gather(1, s).reshape(G, B, C)
    return ext, torch.where(dead, torch.full_like(dists, float("inf")),
                            dists)


def fanout_merge(ids: torch.Tensor, ds: torch.Tensor, *, k: int):
    """Cross-tier merge: ids/ds [B, M] -> (ext_ids [B, k], dists [B, k])
    with cross-tier copies deduped (closest kept) and (-1, +inf) padding.
    The lexsort by (id, dist) is two stable sorts."""
    ds = torch.where(ids < 0, torch.full_like(ds, float("inf")), ds.float())
    o1 = torch.sort(ds, dim=1, stable=True).indices
    i1 = ids.gather(1, o1)
    o2 = torch.sort(i1, dim=1, stable=True).indices
    order = o1.gather(1, o2)
    sid = ids.gather(1, order)
    sd = ds.gather(1, order)
    dup = torch.zeros_like(sid, dtype=torch.bool)
    dup[:, 1:] = (sid[:, 1:] == sid[:, :-1]) & (sid[:, 1:] >= 0)
    sd = torch.where(dup, torch.full_like(sd, float("inf")), sd)
    top = torch.sort(sd, dim=1, stable=True).indices[:, :k]
    rd = sd.gather(1, top)
    fin = torch.isfinite(rd)
    ri = torch.where(fin, sid.gather(1, top), torch.full_like(rd, -1,
                                                             dtype=sid.dtype))
    return ri, rd


def unified_search(stack: LaneStack, temp_tables: Optional[torch.Tensor],
                   lti_table: Optional[torch.Tensor],
                   temp_drop: Optional[torch.Tensor],
                   lti_drop: Optional[torch.Tensor],
                   queries: torch.Tensor, cfg: IndexConfig, *, k: int,
                   k_lane: int, L: int, beam_width: Optional[int] = None,
                   rerank: bool = True):
    """The whole §5.2 steady-state query on the device: every lane's beam
    search, the LTI rerank, per-lane top-``k_lane``, slot -> external id
    against each group's table (``temp_tables`` [Tt, temp_cap],
    ``lti_table`` [lti_cap]), the DeleteList drop, and the global top-k.
    Returns (ext_ids [B, k], dists [B, k], hops [T, B], cmps [T, B])."""
    ids, d, hops, cmps = search_lanes(stack, queries, cfg, k=k_lane, L=L,
                                      beam_width=beam_width, rerank=rerank)
    B = queries.shape[0]
    Tt = stack.n_temp_lanes
    parts_i, parts_d = [], []
    if stack.temps is not None:
        ext, dd = lanes_to_ext(temp_tables, temp_drop, ids[:Tt], d[:Tt])
        parts_i.append(ext.permute(1, 0, 2).reshape(B, -1))
        parts_d.append(dd.permute(1, 0, 2).reshape(B, -1))
    if stack.lti is not None:
        ext, dd = lanes_to_ext(lti_table[None], lti_drop[None], ids[Tt:],
                               d[Tt:])
        parts_i.append(ext[0])
        parts_d.append(dd[0])
    mi, md = fanout_merge(torch.cat(parts_i, 1), torch.cat(parts_d, 1), k=k)
    return mi, md, hops, cmps


def build(vectors, cfg: IndexConfig, batch: int = 256, passes: int = 1,
          seed: int = 0, shuffle: bool = True,
          device="cuda") -> GraphState:
    """Static build = streamed FreshVamana inserts (the insert order is
    ``numpy.random.default_rng(seed).permutation``, as in the reference).
    The batch size is capped at n//8: points inside one batch cannot see
    each other."""
    from .config import resolve_device
    dev = resolve_device(device)
    n, d = vectors.shape
    if n > cfg.capacity or d != cfg.dim:
        raise ValueError(f"build: {n}x{d} vectors for capacity "
                         f"{cfg.capacity}, dim {cfg.dim}")
    batch = max(16, min(batch, n // 8)) if n >= 32 else max(1, n // 2)
    vecs = torch.as_tensor(np.asarray(vectors, np.float32)).to(dev)
    state = empty_graph(cfg, dev)
    state.vectors[:n] = vecs.to(state.vectors.dtype)
    mask = torch.zeros(cfg.capacity, dtype=torch.bool, device=dev)
    mask[:n] = True
    start = medoid(state.vectors, mask)
    # Seed: the medoid point is active with no edges.
    state.active[start.long()] = True
    state = state._replace(start=start, n_total=torch.tensor(
        n, dtype=torch.int32, device=dev))

    rng = np.random.default_rng(seed)
    order = rng.permutation(n) if shuffle else np.arange(n)
    order_t = torch.as_tensor(order, dtype=torch.int32).to(dev)
    for _ in range(passes):
        for lo in range(0, n, batch):
            sl = order_t[lo:lo + batch]
            slots = torch.full((batch,), INVALID, dtype=torch.int32,
                               device=dev)
            slots[:len(sl)] = sl
            bv = torch.zeros((batch, d), device=dev)
            bv[:len(sl)] = vecs[sl.long()]
            state = insert(state, slots, bv, cfg)
    return state


def brute_force(vectors: torch.Tensor, mask: torch.Tensor,
                queries: torch.Tensor, k: int,
                chunk: int = 256) -> torch.Tensor:
    """Exact k-NN over masked rows (ground truth for recall); ties go to the
    lower index, as ``jax.lax.top_k``."""
    outs = []
    for lo in range(0, queries.shape[0], chunk):
        d = l2_sq_batch(queries[lo:lo + chunk], vectors)
        d = torch.where(mask[None, :], d, torch.full_like(d, float("inf")))
        outs.append(torch.sort(d, dim=1, stable=True).indices[:, :k])
    return torch.cat(outs)


def recall_at_k(found_ids: torch.Tensor, true_ids: torch.Tensor) -> float:
    """k-recall@k (Definition 1.1): |X ∩ G| / k averaged over queries."""
    k = true_ids.shape[1]
    eq = found_ids[:, :, None] == true_ids[:, None, :]
    inter = eq.any(2) & (found_ids >= 0)
    return float(inter.sum(1).float().mean() / k)
