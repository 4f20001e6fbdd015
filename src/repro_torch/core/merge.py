"""StreamingMerge (paper §5.3): fold staged inserts and the DeleteList into
the LTI in three phases, every distance from the PQ codes (PyTorch port of
``core/merge.py``).

  Delete phase  Algorithm 4 over the LTI, block by block
                (``delete.consolidate_deletes{_codes}``: the
                ``delete_repair_{fp,sdc}`` kernels on the card).
  Insert phase  a PQ-navigated beam search on the intermediate LTI per new
                point, RobustPrune for its out-edges (``robust_prune_fp``
                on PQ-decoded vectors, or ``robust_prune_sdc`` under
                ``use_sdc``), the back edges staged as the Delta pair list.
  Patch phase   Delta grouped by target and applied with the
                append-or-prune rule (``insert.patch_delta``).

Routes (``streaming_merge``):

- arrival order, the Delete phase sweeping globally or only the affected
  rows (``repair_mode``).  The reference runs the global route as one
  jitted program and the local one with an eager Delete phase; here both
  are the same eager code and differ only in the sweep, whose results are
  equal.  The insert chunks run in arrival order; new points get no
  in-edges until the Patch phase, so chunks do not see each other.
- ``locality=True``: the staged rows are proximity-ordered
  (``locality.locality_order``), slots are taken from topology blocks the
  Delete phase already dirtied first, and each chunk's Delta is patched
  before the next chunk searches, at a power-of-two bucket of its
  measured distinct targets.

The merge never writes the input LTI's tensors: it works on copies, so a
search racing a background merge sees the old generation whole.  The host
syncs are the reference's: the affected ids of a local sweep, and the
per-chunk distinct-target count of the ordered route.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from . import pq as pqm
from .config import IndexConfig, PQConfig
from .delete import (consolidate_deletes, consolidate_deletes_codes,
                     repair_cap_overflow)
from .distance import INVALID
from .insert import compute_insert_edges, patch_delta
from .locality import locality_order, next_bucket
from .lti import LTIState
from .prune import FullPrecisionPrune, SDCPrune, robust_prune_batch
from .search import PQBackend, beam_search

# Expansion cap of the SDC delete repair (candidate width R + cap*R).
SDC_REPAIR_CAP = 8

# The 4 KB SSD-sector granularity of the storage layout's topology file:
# the locality merge places new rows in blocks of this size that the
# Delete phase already dirtied.
TOPOLOGY_BLOCK_BYTES = 4096


class MergeStats(NamedTuple):
    n_deleted: int
    n_inserted: int
    n_backedge_pairs: int
    slots: torch.Tensor          # [Nn] int32 slot per staged row (INVALID ok)
    repair_cap_overflows: int    # nodes whose SDC repair dropped >= 1
    #   expansion ball (deleted out-neighbours > SDC_REPAIR_CAP); always 0
    #   without use_sdc, whose expansion is uncapped
    n_backedge_targets: int      # DISTINCT Delta targets of the Patch phase
    n_prune_rows: int            # rows the Patch phase sent to the prune
    #   engine.  The port processes only distinct targets and prunes only
    #   the rows whose Delta overflows R, so this is what it launched, not
    #   the reference's fixed-shape min(P, N) (arrival order) or sum of
    #   power-of-two buckets (locality route).


def streaming_merge(lti: LTIState, new_vecs, new_valid, delete_mask,
                    cfg: IndexConfig, pq_cfg: PQConfig, *,
                    insert_chunk: int = 256, block: int = 1024,
                    use_sdc: bool = False, repair_mode: Optional[str] = None,
                    locality: bool = False, locality_seed: int = 0,
                    locality_medoids: Optional[torch.Tensor] = None,
                    timings: Optional[dict] = None
                    ) -> tuple[LTIState, MergeStats]:
    """Merge ``new_vecs`` [Nn, d] (rows with ``new_valid`` [Nn] False are
    padding) into the LTI and remove the ``delete_mask`` [capacity] rows.

    ``use_sdc``: every prune distance straight from the PQ codes through
    the SDC tables (equal to pruning on decoded vectors, ~16x fewer bytes).
    ``locality``: the ordered route, its medoids drawn from
    ``locality_seed`` unless ``locality_medoids`` gives their indices.
    ``timings``: when a dict, the seconds of each phase are added to its
    "delete", "insert" and "patch" entries (the device synchronized at
    every phase boundary).  Returns the new LTI and its ``MergeStats``."""
    dev = lti.graph.device
    clock = _PhaseClock(timings, dev)
    new_vecs = torch.as_tensor(new_vecs).to(dev, torch.float32)
    new_valid = torch.as_tensor(new_valid).to(dev, torch.bool)
    delete_mask = torch.as_tensor(delete_mask).to(dev, torch.bool)
    mode = cfg.repair_mode if repair_mode is None else repair_mode
    g, tables, decoded, n_del, overflow = _delete_phase(
        lti, delete_mask, cfg, pq_cfg, block=block, use_sdc=use_sdc,
        mode=mode)
    clock.lap("delete")
    if locality:
        return _streaming_merge_ordered(
            lti, g, tables, decoded, n_del, overflow, new_vecs, new_valid,
            cfg, pq_cfg, insert_chunk=insert_chunk, block=block,
            use_sdc=use_sdc, seed=locality_seed, medoids=locality_medoids,
            clock=clock)
    return _insert_patch_phases(
        g, lti.codes, lti.codebook, tables, decoded, new_vecs, new_valid,
        n_del, overflow, cfg, pq_cfg, insert_chunk=insert_chunk,
        block=block, use_sdc=use_sdc, clock=clock)


class _PhaseClock:
    """Adds the seconds since the last lap to ``timings[phase]`` (after
    synchronizing the device); inert when ``timings`` is None."""

    def __init__(self, timings: Optional[dict], device: torch.device):
        self.timings = timings
        self.device = device
        self.t = time.perf_counter()

    def lap(self, phase: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[phase] = self.timings.get(phase, 0.0) + now - self.t
        self.t = now


def _delete_phase(lti, delete_mask, cfg, pq_cfg, *, block, use_sdc, mode):
    """Phase 1: mark the DeleteList and run Algorithm 4 on PQ distances
    (paper: "we use the compressed PQ vectors ... to calculate the
    approximate distances").  Returns (graph, SDC tables or None, decoded
    table or None, deleted count, cap overflows)."""
    g = lti.graph
    dm = delete_mask & g.active
    n_del = int(dm.sum())
    g = g._replace(deleted=g.deleted | dm)
    if use_sdc:
        tables = pqm.sdc_tables(lti.codebook).contiguous()
        overflow = repair_cap_overflow(g.adjacency, g.deleted,
                                       g.active & ~g.deleted, SDC_REPAIR_CAP)
        g = consolidate_deletes_codes(g, cfg, lti.codes, tables, block=block,
                                      cap=SDC_REPAIR_CAP, mode=mode)
        return g, tables, None, n_del, overflow
    decoded = pqm.decode(lti.codebook, lti.codes, pq_cfg).float()
    g = consolidate_deletes(g, cfg, block=block, prune_table=decoded,
                            mode=mode)
    return g, None, decoded, n_del, 0


def _store_new(g, old_codes, codebook, decoded, vecs, slots, pq_cfg):
    """Write the new rows at their slots (INVALID skipped) into copies of
    the vectors, codes and active flags (and ``decoded`` in place); the
    first new slot seeds an emptied index's entry point.  Returns
    (graph, codes)."""
    ok = slots >= 0
    ws = slots[ok].long()
    new_codes = pqm.encode(codebook, vecs, pq_cfg)
    codes = old_codes.clone()
    codes[ws] = new_codes[ok]
    vectors = g.vectors.clone()
    vectors[ws] = vecs[ok].to(vectors.dtype)
    active = g.active.clone()
    active[ws] = True
    if decoded is not None:
        decoded[ws] = pqm.decode(codebook, new_codes[ok], pq_cfg)
    start = g.start
    if int(start) < 0 and len(ws):
        start = slots[ok][0]
    n_total = g.n_total
    if len(ws):
        n_total = torch.maximum(n_total, slots.max() + 1)
    return g._replace(vectors=vectors, active=active,
                      start=start.to(torch.int32),
                      n_total=n_total.to(torch.int32)), codes


def _chunks(slots, vecs, insert_chunk):
    """Rows in chunks of ``insert_chunk``, the last padded with INVALID
    slots and zero vectors."""
    Nn = slots.shape[0]
    pad = max(1, -(-Nn // insert_chunk)) * insert_chunk - Nn
    slots = torch.cat([slots, slots.new_full((pad,), INVALID)])
    vecs = torch.cat([vecs, vecs.new_zeros((pad, vecs.shape[1]))])
    return list(zip(slots.split(insert_chunk), vecs.split(insert_chunk)))


def _insert_chunk(adjacency, g, usable, codes, codebook, tables, decoded,
                  sl, vv, cfg, *, use_sdc):
    """One insert chunk: search (PQ navigation) + prune, the new rows
    written into ``adjacency`` in place; returns the chunk's Delta pairs
    (pj, pp)."""
    use_kernel = cfg.kernel_enabled(adjacency.device)
    backend = PQBackend(codes, codebook)
    kw = dict(L=cfg.L_build, max_visits=cfg.visits_bound(cfg.L_build),
              beam_width=cfg.beam_width, use_kernel=use_kernel)
    if use_sdc:
        # Prune with d_p = ADC of the exact new vector and SDC between
        # candidates.
        res = beam_search(adjacency, g.active, g.start, vv, backend, **kw)
        cand = torch.cat([res.visited, res.ids], 1)
        ok = ((cand >= 0) & usable[cand.clamp(min=0).long()]
              & (cand != sl[:, None]))
        d_p = backend.distances(backend.prepare(vv), cand,
                                use_kernel=use_kernel)
        new_adj = robust_prune_batch(
            SDCPrune(codes, tables), cand, ok, alpha=cfg.alpha, R=cfg.R,
            use_kernel=use_kernel, d_p=d_p).ids
        src = sl[:, None].expand_as(new_adj).reshape(-1)
    else:
        edges = compute_insert_edges(
            adjacency, g.active, usable, g.start, decoded, sl, vv, backend,
            alpha=cfg.alpha, R=cfg.R, **kw)
        new_adj, src = edges.new_adj, edges.pairs_p
    valid = sl >= 0
    new_adj = torch.where(valid[:, None], new_adj,
                          torch.full_like(new_adj, INVALID))
    adjacency[sl[valid].long()] = new_adj[valid]
    pj = new_adj.reshape(-1)
    return pj, torch.where(pj >= 0, src.to(torch.int32),
                           torch.full_like(pj, INVALID))


def _patch(adjacency, codes, tables, decoded, usable, pj, pp, cfg, *, block,
           use_sdc, affected_cap=None):
    backend = (SDCPrune(codes, tables) if use_sdc
               else FullPrecisionPrune(decoded))
    return patch_delta(adjacency, backend, usable, pj, pp, alpha=cfg.alpha,
                       R=cfg.R, chunk=block,
                       use_kernel=cfg.kernel_enabled(adjacency.device),
                       affected_cap=affected_cap)


def _distinct(pj: torch.Tensor) -> int:
    return int(torch.unique(pj[pj >= 0]).numel())


def _insert_patch_phases(g, old_codes, codebook, tables, decoded, new_vecs,
                         new_valid, n_del, overflow, cfg, pq_cfg, *,
                         insert_chunk, block, use_sdc, clock):
    """Phases 2 (Insert) and 3 (Patch) in arrival order."""
    Nn = new_vecs.shape[0]
    # Free slots for the new rows, lowest first (a stable sort of the
    # free indicator is the reference's top-k over it); row i takes the
    # i-th slot when it is valid and the slot is free.
    free = ~g.active
    slots = torch.sort((~free).to(torch.int8), stable=True).indices[:Nn]
    slots = torch.where(new_valid & free[slots], slots,
                        torch.full_like(slots, INVALID)).to(torch.int32)
    g, codes = _store_new(g, old_codes, codebook, decoded, new_vecs, slots,
                          pq_cfg)
    usable = g.active & ~g.deleted
    adjacency = g.adjacency
    pairs = [_insert_chunk(adjacency, g, usable, codes, codebook, tables,
                           decoded, sl, vv, cfg, use_sdc=use_sdc)
             for sl, vv in _chunks(slots, new_vecs, insert_chunk)]
    pairs_j = torch.cat([p[0] for p in pairs])
    pairs_p = torch.cat([p[1] for p in pairs])
    clock.lap("insert")
    adjacency, n_rows = _patch(adjacency, codes, tables, decoded, usable,
                               pairs_j, pairs_p, cfg, block=block,
                               use_sdc=use_sdc)
    clock.lap("patch")
    stats = MergeStats(n_del, int((slots >= 0).sum()),
                       int((pairs_j >= 0).sum()), slots, overflow,
                       _distinct(pairs_j), n_rows)
    return LTIState(g._replace(adjacency=adjacency), codes, codebook), stats


def _locality_stage(g, phase1_dirty, new_vecs, new_valid, cfg, *, seed,
                    medoids):
    """Proximity-order the staged rows and allocate their slots along the
    ordering: free slots inside 4 KB topology blocks the Delete phase
    already dirtied first, then free slots of clean blocks, ascending.
    Returns (perm, ordered vectors, slots in ordered position)."""
    perm = locality_order(new_vecs, new_valid,
                          n_clusters=cfg.locality_clusters or 16, seed=seed,
                          medoids=medoids)
    p = perm.long()
    ord_vecs, ord_valid = new_vecs[p], new_valid[p]
    cap = g.capacity
    free = ~g.active
    rpb = max(1, TOPOLOGY_BLOCK_BYTES // (cfg.R * 4))
    ar = torch.arange(cap, device=free.device)
    blk = ar // rpb
    block_dirty = torch.zeros(-(-cap // rpb), dtype=torch.bool,
                              device=free.device)
    block_dirty[blk[phase1_dirty]] = True
    rank = torch.where(block_dirty[blk], ar, cap + ar)
    rank = torch.where(free, rank, torch.full_like(rank, 2 * cap))
    slots = torch.sort(rank, stable=True).indices[:new_vecs.shape[0]]
    slots = torch.where(ord_valid & free[slots], slots,
                        torch.full_like(slots, INVALID)).to(torch.int32)
    return perm, ord_vecs, slots


def _streaming_merge_ordered(lti, g, tables, decoded, n_del, overflow,
                             new_vecs, new_valid, cfg, pq_cfg, *,
                             insert_chunk, block, use_sdc, seed, medoids,
                             clock):
    """The locality route: the ordered rows are inserted chunk by chunk,
    each chunk's Delta patched before the next chunk searches (so chunks
    reach their earlier-inserted cluster mates), at a power-of-two bucket
    of the chunk's distinct targets."""
    phase1_dirty = adjacency_delta_mask(lti.graph.adjacency, g.adjacency)
    perm, ord_vecs, slots_ord = _locality_stage(
        g, phase1_dirty, new_vecs, new_valid, cfg, seed=seed,
        medoids=medoids)
    g, codes = _store_new(g, lti.codes, lti.codebook, decoded, ord_vecs,
                          slots_ord, pq_cfg)
    usable = g.active & ~g.deleted
    adjacency = g.adjacency
    n_pairs = n_targets = n_rows = 0
    cap_max = min(insert_chunk * cfg.R, g.capacity)
    for sl, vv in _chunks(slots_ord, ord_vecs, insert_chunk):
        pj, pp = _insert_chunk(adjacency, g, usable, codes, lti.codebook,
                               tables, decoded, sl, vv, cfg,
                               use_sdc=use_sdc)
        n_pairs += int((pj >= 0).sum())
        d_c = _distinct(pj)
        clock.lap("insert")
        if d_c == 0:
            continue
        n_targets += d_c
        adjacency, rows = _patch(
            adjacency, codes, tables, decoded, usable, pj, pp, cfg,
            block=block, use_sdc=use_sdc,
            affected_cap=next_bucket(d_c, cap=cap_max))
        n_rows += rows
        clock.lap("patch")
    # Slots in the original row order (perm is a permutation).
    slots = torch.full_like(slots_ord, INVALID)
    slots[perm.long()] = slots_ord
    stats = MergeStats(n_del, int((slots_ord >= 0).sum()), n_pairs, slots,
                       overflow, n_targets, n_rows)
    return LTIState(g._replace(adjacency=adjacency), codes,
                    lti.codebook), stats


def adjacency_delta_mask(old_adj: torch.Tensor, new_adj: torch.Tensor
                         ) -> torch.Tensor:
    """[capacity] bool: the rows a merge rewrote (what a delta patch of
    the on-disk topology has to write)."""
    return (old_adj != new_adj).any(1)
