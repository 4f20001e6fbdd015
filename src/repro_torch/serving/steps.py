"""The ANN serving engine's row-sharded LTI lane: the PyTorch port of the
ANN half of ``serving/steps.py``.

``SystemConfig.shard_lti`` row-partitions the LTI's per-point arrays
(vectors, adjacency, PQ codes, flags) over a device group
(``graph.shard_lti``, ``distributed.sharding``), and
``make_sharded_unified_step`` serves a query batch against it: the temp
lanes as in ``index.unified_search``, the LTI lane sharded.  Inside the
lane the beam-search state (candidate list, frontier, visited set) lives
once, on the lead device, and steps through ``frontier_select`` as in the
unsharded lane; every row access is owner-computed: each shard answers for
the slots it owns on its own device (``gather_rows`` for adjacency rows,
``adc_rows`` for PQ distances, ``l2_rows`` for the exact rerank, on the
card; their plain versions on the CPU) with the ids it does not own set to
-1, the answers of non-owners become the additive identity, and one sum on
the lead device recombines them (``distributed.ctx.psum``).  Integer sums
are exact and a finite non-negative distance plus zeros is itself, so the
lane returns the unsharded lane's ids, distances, hops and cmps bit for
bit, for any shard count, on the card and on the CPU.

``make_disk_lti_lane`` is the storage tier's sibling: the LTI lane with its
adjacency rows read off the on-disk layout.

The LM steps: ``make_lm_prefill_step`` (the last position's logits and
the KV caches of a prompt batch) and ``make_lm_decode_step`` (one greedy
token against the caches, which it updates in place).  The recsys steps:
``make_recsys_serve_step`` (click probabilities of the FM family) and
``make_retrieval_step`` (the exact candidate-scoring baseline at the
``retrieval_cand`` shape).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..core import index as mem
from ..core import pq as pqm
from ..core.config import IndexConfig
from ..core.distance import INVALID
from ..core.graph import GraphState, LaneStack
from ..core.search import (FullPrecisionBackend, PQBackend, batch_distances,
                           beam_search, topk_masked)
from ..distributed.ctx import psum
from ..kernels import ops
from ..models import recsys as rec
from ..models import transformer as tf


def _owned(ids: torch.Tensor, offset: int, n_local: int):
    """(owned mask, local ids with -1 where not owned) for global slot ids
    on the shard owning ``[offset, offset + n_local)``."""
    loc = ids - offset
    own = (ids >= 0) & (loc >= 0) & (loc < n_local)
    return own, torch.where(own, loc, torch.full_like(loc, INVALID))


class _Shards:
    """The shard layout one lane works on: each shard's device and first
    slot, and the lead device that holds the search state."""

    def __init__(self, devices: Sequence, n_local: int, lead):
        self.devices = [torch.device(d) for d in devices]
        self.n_local = n_local
        self.lead = torch.device(lead)

    def each(self, ids: torch.Tensor):
        """(shard index, device, owned mask, local ids) per shard, the ids
        moved to the shard's device."""
        for s, dev in enumerate(self.devices):
            own, loc = _owned(ids.to(dev), s * self.n_local, self.n_local)
            yield s, dev, own, loc


def shard_gather_mask(masks: Sequence[torch.Tensor], ids: torch.Tensor,
                      shards: _Shards) -> torch.Tensor:
    """A row-sharded bool array at global ids: the owner contributes its
    flag, every other shard 0, one sum recombines; ids < 0 -> False (the
    dense ``(ids >= 0) & mask[max(ids, 0)]``)."""
    parts = []
    for s, _, own, loc in shards.each(ids):
        hit = masks[s][loc.clamp(min=0).long()] & own
        parts.append(hit.to(torch.int32))
    return psum(parts, shards.lead) > 0


class ShardedRows:
    """Owner-computes ``search.GraphSource`` over row-sharded graph arrays:
    each shard gathers the rows it owns with ``gather_rows`` (ids it does
    not own are -1 and give INVALID rows), ``row - INVALID`` is 0 for
    those, and the sum plus INVALID is the dense gather, INVALID frontier
    slots included."""

    def __init__(self, adjacency: Sequence[torch.Tensor],
                 active: Sequence[torch.Tensor], shards: _Shards,
                 use_kernel: bool):
        self.adjacency = adjacency          # [n_local, R] per shard
        self.active = active                # [n_local] per shard
        self.shards = shards
        self.use_kernel = use_kernel

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        parts = [ops.gather_rows(self.adjacency[s], loc,
                                 use_kernel=self.use_kernel) - INVALID
                 for s, _, _, loc in self.shards.each(ids)]
        return psum(parts, self.shards.lead) + INVALID

    def node_ok(self, ids: torch.Tensor) -> torch.Tensor:
        return shard_gather_mask(self.active, ids, self.shards)


def _owner_distances(backends, ctx: torch.Tensor, ids: torch.Tensor,
                     shards: _Shards, use_kernel: bool) -> torch.Tensor:
    """Each shard's backend scores the ids it owns (the dense backend's own
    routing: its kernel on the card, its plain engine path on the CPU), 0
    elsewhere; the sum is the dense distance, +inf at ids < 0."""
    parts = []
    for s, dev, own, loc in shards.each(ids):
        d = backends[s].distances(ctx.to(dev), loc, use_kernel=use_kernel)
        parts.append(torch.where(own, d, torch.zeros_like(d)))
    d = psum(parts, shards.lead)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


class ShardedADC:
    """Owner-computes PQ asymmetric distances (the sharded ``PQBackend``):
    the owner evaluates ADC on its local code rows, the same arithmetic and
    hence the same f32 bits as the dense lane."""

    def __init__(self, codes: Sequence[torch.Tensor], codebook: torch.Tensor,
                 shards: _Shards):
        self.codebook = pqm.PQCodebook(codebook)
        self.backends = [PQBackend(c, self.codebook) for c in codes]
        self.shards = shards

    def prepare(self, queries: torch.Tensor) -> torch.Tensor:
        return pqm.lut(self.codebook, queries).contiguous()

    def distances(self, ctx: torch.Tensor, ids: torch.Tensor, *,
                  use_kernel: bool = False) -> torch.Tensor:
        return _owner_distances(self.backends, ctx, ids, self.shards,
                                use_kernel)


class ShardedExact:
    """Owner-computes exact squared L2 (the sharded
    ``FullPrecisionBackend``): the LTI lane's full-precision rerank, whose
    vector rows live sharded."""

    def __init__(self, vectors: Sequence[torch.Tensor], shards: _Shards):
        self.backends = [FullPrecisionBackend(v) for v in vectors]
        self.shards = shards

    def prepare(self, queries: torch.Tensor) -> torch.Tensor:
        return queries.float().contiguous()

    def distances(self, ctx: torch.Tensor, ids: torch.Tensor, *,
                  use_kernel: bool = False) -> torch.Tensor:
        return _owner_distances(self.backends, ctx, ids, self.shards,
                                use_kernel)


def make_sharded_lti_lane(devices: Sequence, cfg: IndexConfig, *,
                          k_lane: int, L: int,
                          beam_width: Optional[int] = None,
                          rerank: bool = True) -> Callable:
    """The LTI lane over row-sharded arrays: PQ-navigated beam search,
    exact rerank, per-lane top-k.

    Returns ``(graphs, codes, codebook, queries) -> (slot_ids [B, k_lane],
    dists, hops [B], cmps [B])`` for the ``graph.shard_lti`` layout on
    ``devices`` (``graphs``/``codes`` one block per shard), on the device of
    ``queries``: equal, counters included, to the LTI lane of
    ``index.search_lanes`` for any shard count.
    """
    W = beam_width or cfg.beam_width

    def lane(graphs: Sequence[GraphState], codes: Sequence[torch.Tensor],
             codebook: torch.Tensor, queries: torch.Tensor):
        if len(graphs) != len(devices):
            raise ValueError(f"{len(graphs)} LTI blocks for a group of "
                             f"{len(devices)} shards")
        lead = queries.device
        shards = _Shards(devices, graphs[0].capacity, lead)
        use_kernel = cfg.kernel_enabled(lead)
        src = ShardedRows([g.adjacency for g in graphs],
                          [g.active for g in graphs], shards, use_kernel)
        res = beam_search(None, None, graphs[0].start.to(lead), queries,
                          ShardedADC(codes, codebook.to(lead), shards),
                          L=L, max_visits=cfg.visits_bound(L),
                          beam_width=W, use_kernel=use_kernel, source=src,
                          R=graphs[0].R)
        ok = shard_gather_mask([g.active & ~g.deleted for g in graphs],
                               res.ids, shards)
        dists = res.dists
        if rerank:
            # DeleteList members masked BEFORE the gather (the
            # ``rerank_candidates`` contract), on the ok mask.
            dists = batch_distances(
                ShardedExact([g.vectors for g in graphs], shards), queries,
                torch.where(ok, res.ids, torch.full_like(res.ids, INVALID)),
                use_kernel=use_kernel)
        ids, d = topk_masked(res.ids, dists, ok, k_lane)
        return ids, d, res.n_hops, res.n_cmps

    return lane


def make_sharded_unified_step(devices: Sequence, cfg: IndexConfig, *,
                              k: int, k_lane: int, L: int,
                              beam_width: Optional[int] = None,
                              rerank: bool = True) -> Callable:
    """The unified §5.2 fan-out with the LTI lane row-sharded over
    ``devices``.

    Mirrors ``index.unified_search`` (temp lanes as one beam search at temp
    capacity, per-group slot -> ext mapping, DeleteList drop, cross-tier
    dedupe and top-k) with the LTI lane run by ``make_sharded_lti_lane``.
    The step takes ``(stack, t_tabs, l_tab, t_drop, l_drop, queries)``
    where ``stack.lti``/``stack.codes`` hold the ``graph.shard_lti``
    blocks, and returns (ext_ids [B, k], dists [B, k], hops [T, B],
    cmps [T, B]) equal to the unsharded program's.
    """
    lane = make_sharded_lti_lane(devices, cfg, k_lane=k_lane, L=L,
                                 beam_width=beam_width, rerank=rerank)

    def step(stack: LaneStack, t_tabs, l_tab, t_drop, l_drop,
             queries: torch.Tensor):
        B = queries.shape[0]
        parts_i, parts_d, hops, cmps = [], [], [], []
        if stack.temps is not None:
            tids, td, th, tc = mem.search_lanes(
                LaneStack(stack.temps, None, None, None), queries, cfg,
                k=k_lane, L=L, beam_width=beam_width)
            ext, dd = mem.lanes_to_ext(t_tabs, t_drop, tids, td)
            parts_i.append(ext.permute(1, 0, 2).reshape(B, -1))
            parts_d.append(dd.permute(1, 0, 2).reshape(B, -1))
            hops.append(th)
            cmps.append(tc)
        lids, ld, lh, lc = lane(stack.lti, stack.codes, stack.codebook,
                                queries)
        ext, dd = mem.lanes_to_ext(l_tab[None], l_drop[None], lids[None],
                                   ld[None])
        parts_i.append(ext[0])
        parts_d.append(dd[0])
        hops.append(lh[None])
        cmps.append(lc[None])
        mi, md = mem.fanout_merge(torch.cat(parts_i, 1),
                                  torch.cat(parts_d, 1), k=k)
        return mi, md, torch.cat(hops), torch.cat(cmps)

    return step


def make_disk_lti_lane(layout, cfg: IndexConfig, *, k_lane: int, L: int,
                       beam_width: Optional[int] = None, rerank: bool = True,
                       cache_mb: int = 0, prefetch_depth: int = 1,
                       latency_us: float = 0.0, device="cuda") -> Callable:
    """The LTI lane served off a decoupled on-disk layout: PQ navigation on
    in-memory codes, adjacency rows from ``topology.bin`` through the block
    cache and the prefetch pipeline, the exact rerank from ``data.bin``.

    Returns ``(queries) -> (slot_ids [B, k_lane], dists, hops, cmps,
    reads)``; with the cache off equal to the in-memory lane at any
    prefetch depth.  ``lane.searcher`` is the ``DiskLTISearcher`` (IO in
    ``lane.searcher.stats``); ``lane.close()`` stops the prefetch thread.
    """
    from ..storage.source import DiskLTISearcher
    searcher = DiskLTISearcher(layout, cfg, cache_mb=cache_mb,
                               prefetch_depth=prefetch_depth,
                               latency_us=latency_us, device=device)
    W = beam_width or cfg.beam_width

    def lane(queries):
        return searcher.search(queries, k=k_lane, L=L, beam_width=W,
                               rerank=rerank)

    lane.searcher = searcher
    lane.close = searcher.close
    return lane


# ---------------------------------------------------------------------------
# LM: prefill and decode
# ---------------------------------------------------------------------------

def make_lm_prefill_step(cfg: tf.TransformerConfig) -> Callable:
    """``prefill(params, tokens)`` -> (logits [B, V] of the last position,
    caches): the prompt's KV caches as ``transformer.forward`` collects
    them (the last W tokens of each layer at slots 0..W-1)."""
    def prefill(params, tokens):
        logits, _, caches = tf.forward(params, tokens, cfg,
                                       collect_cache=True, last_only=True)
        return logits[:, -1], caches

    return prefill


def make_lm_decode_step(cfg: tf.TransformerConfig) -> Callable:
    """``decode(params, caches, tokens, pos)`` -> (next_token [B] int32,
    the greedy argmax (the first maximum on ties, as ``jnp.argmax``),
    logits [B, V], caches): the caches are updated in place."""
    def decode(params, caches, tokens, pos):
        logits, new_caches = tf.decode_step(params, caches, tokens, pos, cfg)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, new_caches

    return decode


# ---------------------------------------------------------------------------
# Recsys: click scoring and the exact retrieval baseline
# ---------------------------------------------------------------------------

def make_recsys_serve_step(cfg: rec.RecsysConfig) -> Callable:
    """``serve(model, ids)``: click probabilities [B] of an FM-family
    model for ids [B, n_sparse] (pre-offset per field)."""
    def serve(model, ids):
        with torch.no_grad():
            return torch.sigmoid(rec.recsys_forward(model, ids, cfg))

    return serve


def make_retrieval_step(cfg: rec.RecsysConfig, k: int = 100) -> Callable:
    """Exact candidate-scoring baseline for the retrieval_cand shape:
    ``retrieve(model, user_ids, item_table)`` -> (scores, ids) [B, k].

    For FM-family models the query embedding is the summed field embedding
    (the factorized part); for SASRec the final-position hidden state.
    Items are rows of a candidate table.  The ANN path swaps this for a
    FreshDiskANN search over the table."""
    def retrieve(model, user_ids, item_table):
        with torch.no_grad():
            if cfg.kind == "sasrec":
                q = rec.sasrec_user_embedding(model, user_ids, cfg)
            else:
                q = rec.field_lookup(model.V, user_ids, cfg).sum(-2)
            return rec.retrieval_topk(q, item_table, k)

    return retrieve
