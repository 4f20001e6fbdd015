"""Distributed FreshDiskANN steps over a device group: the PyTorch port of
``launch/ann_steps.py``, the freshdiskann-1b deployment's search, insert
and merge.

The paper's own distribution design (§1): every device hosts an
independent sub-index; queries are broadcast to every shard and the
results top-k-merged; updates are routed to one shard by an id hash;
StreamingMerge is shard-local.

The global LTI keeps the reference's stacked layout, so that
``convert.lti_state`` carries a reference LTI across unchanged: its
per-point arrays hold the n shards' sub-indices as n blocks of
``cfg.capacity`` rows, ``start`` and ``n_total`` are [n] (one per shard)
and the PQ codebook is shared.  The group is a list of devices
(``distributed.sharding.data_mesh``); shard s runs on ``devices[s]`` with
its block (a view when the stacked arrays already lie there) and the
stacked arrays' device recombines: the search concatenates every shard's
candidates and merges them with the ``block_topk`` kernel, the insert
writes each shard's block in place, the merge concatenates the new
sub-indices.

``jax.lax.top_k`` over 0/1 indicators picks the rows and free slots a
shard takes; it puts the lower index first among equal values, and
``_top_k_indicator`` keeps that order.  The reference's ``abstract_lti``
builds abstract shapes for XLA's dry run and has no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core import pq as pqm
from ..core.config import IndexConfig, PQConfig
from ..core.graph import GraphState
from ..core.index import insert as mem_insert
from ..core.lti import LTIState
from ..core.merge import streaming_merge
from ..core.search import (FullPrecisionBackend, PQBackend, batch_distances,
                           beam_search, topk_results)
from ..distributed.ctx import all_gather
from ..distributed.sharding import REPLICATED, ROWS
from ..kernels import ops

_HASH = np.uint32(2654435761)     # Knuth's multiplicative hash


def shard_specs(devices: Sequence):
    """(LTIState of specs, codebook spec, n_shards): every per-point array,
    ``start`` and ``n_total`` split into one block per shard, the codebook
    replicated."""
    graph = GraphState(vectors=ROWS, adjacency=ROWS, active=ROWS,
                       deleted=ROWS, start=ROWS, n_total=ROWS)
    return (LTIState(graph=graph, codes=ROWS, codebook=REPLICATED),
            REPLICATED, len(devices))


def _check(lti: LTIState, cfg: IndexConfig, n: int) -> None:
    if lti.graph.capacity != n * cfg.capacity or lti.graph.start.shape != (
            n,):
        raise ValueError(
            f"stacked LTI of {lti.graph.capacity} rows and start "
            f"{tuple(lti.graph.start.shape)} for {n} shards of capacity "
            f"{cfg.capacity}")


def shard_block(lti: LTIState, s: int, capacity: int, device) -> LTIState:
    """Shard s's sub-index of a stacked LTI on ``device``: its rows
    ``[s*capacity, (s+1)*capacity)`` (views when already there), its
    scalar entry point and watermark, and the shared codebook."""
    g = lti.graph
    rows = slice(s * capacity, (s + 1) * capacity)
    local = GraphState(g.vectors[rows].to(device), g.adjacency[rows].to(device),
                       g.active[rows].to(device), g.deleted[rows].to(device),
                       g.start[s].to(device), g.n_total[s].to(device))
    return LTIState(local, lti.codes[rows].to(device),
                    pqm.PQCodebook(lti.codebook.centroids.to(device)))


def stack_blocks(blocks: Sequence[LTIState], device) -> LTIState:
    """The stacked LTI of per-shard sub-indices, on ``device``."""
    def cat(xs):
        return torch.cat([x.to(device) for x in xs])

    graph = GraphState(*(cat([getattr(b.graph, f) for b in blocks])
                         for f in ("vectors", "adjacency", "active",
                                   "deleted")),
                       all_gather([b.graph.start for b in blocks], device),
                       all_gather([b.graph.n_total for b in blocks], device))
    return LTIState(graph, cat([b.codes for b in blocks]),
                    pqm.PQCodebook(blocks[0].codebook.centroids.to(device)))


def _owner(B: int, n_shards: int) -> np.ndarray:
    """The shard each of B staged rows is routed to (an id hash)."""
    return ((np.arange(B, dtype=np.uint32) * _HASH) % np.uint32(n_shards)
            ).astype(np.int32)


def _top_k_indicator(mask: np.ndarray, k: int):
    """``jax.lax.top_k(mask.astype(int32), k)``: (values [k] bool, indices
    [k]): the set entries in index order, then the unset ones in index
    order.  Past the mask's length it pads with (False, 0)."""
    order = np.argsort(~mask, kind="stable")[:k]
    take = mask[order]
    if len(order) < k:
        pad = k - len(order)
        order = np.concatenate([order, np.zeros(pad, order.dtype)])
        take = np.concatenate([take, np.zeros(pad, bool)])
    return take, order


def _pick_rows(owner: np.ndarray, s: int, valid: np.ndarray, k: int):
    """(take [k] bool, rows [k] int64 with -1 where not taken): up to k of
    the rows routed to shard s, in row order."""
    take, rows = _top_k_indicator((owner == s) & valid, k)
    return take, np.where(take, rows, -1)


def _gather_rows(new_vecs: torch.Tensor, rows: np.ndarray, device):
    r = torch.as_tensor(rows).to(device)
    v = new_vecs.to(device)[r.clamp(min=0)]
    return torch.where((r >= 0)[:, None], v, torch.zeros_like(v))


def make_distributed_search(devices: Sequence, cfg: IndexConfig, *, k: int,
                            L: Optional[int] = None,
                            beam_width: Optional[int] = None) -> Callable:
    """``(lti, queries [Q, d]) -> (ids [Q, k] int32, dists [Q, k])``.

    Every shard runs the PQ-navigated beam search over its sub-index with
    the exact rerank of its candidate list (paper §5.2: the full-precision
    rerank is what makes distances comparable across shards) and its local
    top-k, ids offset into the stacked point axis; the lead device gathers
    the n x k candidates of each query in shard order and keeps the k
    smallest with one ``block_topk`` launch, or for k above its 128 with a
    stable sort (either is the reference's stable ``argsort``: the lower
    shard first among equal distances; a non-finite pick gives id -1).
    """
    L = L or cfg.L_search
    W = beam_width or cfg.beam_width
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def search(lti: LTIState, queries: torch.Tensor):
        _check(lti, cfg, n)
        lead = lti.graph.vectors.device
        parts_i, parts_d = [], []
        for s, dev in enumerate(devices):
            blk = shard_block(lti, s, cfg.capacity, dev)
            g = blk.graph
            q = queries.to(dev)
            use_kernel = cfg.kernel_enabled(dev)
            res = beam_search(g.adjacency, g.active, g.start, q,
                              PQBackend(blk.codes, blk.codebook), L=L,
                              max_visits=cfg.visits_bound(L), beam_width=W,
                              use_kernel=use_kernel)
            exact = batch_distances(FullPrecisionBackend(g.vectors), q,
                                    res.ids, use_kernel=use_kernel)
            ids, d = topk_results(res._replace(dists=exact), k,
                                  g.active & ~g.deleted)
            ids = torch.where(ids >= 0, ids + s * cfg.capacity, ids)
            parts_i.append(ids)
            parts_d.append(d)
        all_i = all_gather(parts_i, lead)             # [n, Q, k]
        all_d = all_gather(parts_d, lead)
        Q = queries.shape[0]
        flat_i = all_i.permute(1, 0, 2).reshape(Q, n * k)
        flat_d = all_d.permute(1, 0, 2).reshape(Q, n * k).contiguous()
        if k <= ops.BLOCK_TOPK_MAX_K:
            cols = torch.arange(n * k, dtype=torch.int32, device=lead)
            out_d, col = ops.block_topk(flat_d, cols, k)
        else:
            out_d, col = torch.sort(flat_d, dim=1, stable=True)
            out_d, col = out_d[:, :k], col[:, :k]
            col = torch.where(torch.isfinite(out_d), col,
                              torch.full_like(col, -1))
        out_i = torch.where(col >= 0,
                            flat_i.gather(1, col.clamp(min=0).long()),
                            torch.full_like(col, -1))
        return out_i, out_d

    return search


def _write_back(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a shard's updated block into the stacked array, unless the
    block is that array's own view."""
    if src.data_ptr() != dst.data_ptr() or src.device != dst.device:
        dst.copy_(src)


def make_distributed_insert(devices: Sequence, cfg: IndexConfig,
                            per_shard: int = 32) -> Callable:
    """``(lti, new_vecs [B, d]) -> lti`` with hash-routed inserts, in place
    (the reference donates the LTI).

    Each shard takes up to ``per_shard`` of the rows hashed to it, in row
    order, gives them its first free slots, runs Algorithm 2 on its
    sub-index (``index.insert``) and writes their PQ codes.  No shard reads
    another's rows.
    """
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def insert(lti: LTIState, new_vecs: torch.Tensor) -> LTIState:
        _check(lti, cfg, n)
        B, dim = new_vecs.shape
        owner = _owner(B, n)
        cap = cfg.capacity
        m, ksub = lti.codes.shape[1], lti.codebook.centroids.shape[1]
        pq_cfg = PQConfig(dim=dim, m=m, ksub=ksub)
        for s, dev in enumerate(devices):
            blk = shard_block(lti, s, cap, dev)
            g = blk.graph
            take, rows = _pick_rows(owner, s, np.ones(B, bool), per_shard)
            vecs = _gather_rows(new_vecs, rows, dev)
            free = ~g.active.cpu().numpy()
            _, slots = _top_k_indicator(free, per_shard)
            slots = np.where(take & free[slots], slots, -1).astype(np.int32)
            st = mem_insert(g, torch.as_tensor(slots).to(dev), vecs, cfg)
            codes = pqm.encode(blk.codebook, vecs, pq_cfg)
            ok = slots >= 0
            blk.codes[torch.as_tensor(slots[ok]).long().to(dev)] = codes[
                torch.as_tensor(ok).to(dev)]
            rows_ = slice(s * cap, (s + 1) * cap)
            gl = lti.graph
            for dst, src in ((gl.vectors[rows_], st.vectors),
                             (gl.adjacency[rows_], st.adjacency),
                             (gl.active[rows_], st.active),
                             (gl.deleted[rows_], st.deleted),
                             (lti.codes[rows_], blk.codes)):
                _write_back(dst, src)
            gl.start[s] = st.start.to(gl.start.device)
            gl.n_total[s] = st.n_total.to(gl.n_total.device)
        return lti

    return insert


def make_distributed_merge(devices: Sequence, cfg: IndexConfig,
                           pq_cfg: PQConfig, *, insert_chunk: int = 256,
                           block: int = 1024,
                           use_sdc: bool = False) -> Callable:
    """``(lti, new_vecs [B, d], new_valid [B], delete_mask [n*capacity])
    -> merged lti``.  StreamingMerge runs shard-local: each shard merges
    up to ``max(B // n * 4, 8)`` of the valid rows hashed to it (chunks of
    ``min(insert_chunk, that)``) and its slice of the DeleteList.
    """
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def merge(lti: LTIState, new_vecs: torch.Tensor, new_valid,
              delete_mask) -> LTIState:
        _check(lti, cfg, n)
        lead = lti.graph.vectors.device
        B = new_vecs.shape[0]
        per_shard = max(B // n * 4, 8)
        owner = _owner(B, n)
        valid = torch.as_tensor(new_valid).cpu().numpy().astype(bool)
        dmask = torch.as_tensor(delete_mask)
        cap = cfg.capacity
        blocks = []
        for s, dev in enumerate(devices):
            blk = shard_block(lti, s, cap, dev)
            take, rows = _pick_rows(owner, s, valid, per_shard)
            merged, _ = streaming_merge(
                blk, _gather_rows(new_vecs, rows, dev),
                torch.as_tensor(take).to(dev),
                dmask[s * cap:(s + 1) * cap].to(dev), cfg, pq_cfg,
                insert_chunk=min(insert_chunk, per_shard), block=block,
                use_sdc=use_sdc)
            blocks.append(merged)
        return stack_blocks(blocks, lead)

    return merge
