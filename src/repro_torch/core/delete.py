r"""Deletion: the lazy DeleteList and its consolidation (Algorithm 4),
PyTorch port of ``core/delete.py``.

``delete`` only marks nodes: deleted nodes stay navigable but are filtered
from results (paper §4.2).  ``consolidate_deletes`` is the batched graph
repair: every live node p with deleted out-neighbours gets

    C  <-  (N_out(p) u  U_{v in N_out(p) n D} N_out(v)) \ D \ {p}
    N_out(p)  <-  RobustPrune(p, C, alpha, R)

block by block (the paper's sequential block scan).  Each block runs one
of two engines, both reading the adjacency as it was before the repair:

  kernel  (``use_kernel``; always on a CUDA device) one ``delete_repair_fp``
          or ``delete_repair_sdc`` launch for the block: the kernel does
          the gathers, the candidate assembly, the prune rounds and the
          changed-row select;
  plain   (the CPU path, the reference's ``use_kernel=False`` engine) the
          candidates assembled in PyTorch and pruned through
          ``prune.prune_node_batch``.

Two sweeps (``IndexConfig.repair_mode``, overridable per call):

- ``"global"``: every ``capacity / block`` block is repaired;
- ``"local"``: only the affected set (live nodes with >= 1 deleted
  out-neighbour, ``affected_mask``), gathered into padded blocks,
  repaired with the same engine and scattered back.  Row repair is
  independent row to row, so the result equals the global sweep's.  The
  affected ids come to the host (their count is data-dependent).

Both return a new ``GraphState``; the input state is not modified.
"""
from __future__ import annotations

import dataclasses

import torch

from .config import IndexConfig
from .distance import INVALID
from .graph import GraphState, medoid
from .prune import FullPrecisionPrune, SDCPrune, prune_node_batch
from ..kernels import ops
from ..kernels.ref import first_deleted


def delete(state: GraphState, slots: torch.Tensor) -> GraphState:
    """Lazy delete: add ``slots`` (INVALID entries ignored) to the
    DeleteList; no graph edits."""
    deleted = state.deleted.clone()
    deleted[slots[slots >= 0].long()] = True
    return state._replace(deleted=deleted)


def _nbr_deleted(adjacency: torch.Tensor, deleted: torch.Tensor
                 ) -> torch.Tensor:
    return (adjacency >= 0) & deleted[adjacency.clamp(min=0).long()]


def affected_mask(adjacency: torch.Tensor, deleted: torch.Tensor,
                  usable: torch.Tensor) -> torch.Tensor:
    """Algorithm 4's loop set: live nodes with >= 1 deleted out-neighbour
    (one forward pass over the adjacency)."""
    return usable & _nbr_deleted(adjacency, deleted).any(1)


def repair_cap_overflow(adjacency: torch.Tensor, deleted: torch.Tensor,
                        usable: torch.Tensor, cap: int) -> int:
    """Live nodes with more deleted out-neighbours than the SDC expansion
    cap: each such repair dropped >= 1 expansion ball (its deleted edges
    are still pruned: the kept-edge mask is uncapped)."""
    over = _nbr_deleted(adjacency, deleted).sum(1) > cap
    return int((over & usable).sum())


def _finish_consolidate(state: GraphState, adjacency: torch.Tensor
                        ) -> GraphState:
    """Slot reclamation and entry-point upkeep.  The start is re-picked
    (the medoid of the live points) when it is deleted, inactive or the
    empty sentinel; with no live point left it becomes INVALID."""
    adjacency = torch.where(state.deleted[:, None],
                            torch.full_like(adjacency, INVALID), adjacency)
    active = state.active & ~state.deleted
    s = int(state.start)
    stale = s < 0 or bool(state.deleted[s]) or not bool(state.active[s])
    if not bool(active.any()):
        start = torch.tensor(INVALID, dtype=torch.int32, device=state.device)
    elif stale:
        start = medoid(state.vectors, active)
    else:
        start = state.start
    return state._replace(adjacency=adjacency, active=active,
                          deleted=torch.zeros_like(state.deleted),
                          start=start.to(torch.int32))


def _sweep(state: GraphState, rows_fn, block: int, mode: str,
           usable: torch.Tensor) -> torch.Tensor:
    """The repaired adjacency: ``rows_fn(ids [block])`` -> new rows, for
    every block (global) or for the affected rows only (local; the padding
    repeats the first affected id, whose duplicate writes are identical).
    Every block reads the pre-repair adjacency."""
    N = state.capacity
    dev = state.device
    if mode == "local":
        aff = affected_mask(state.adjacency, state.deleted,
                            usable).nonzero()[:, 0].to(torch.int32)
        out = state.adjacency.clone()
        if len(aff) == 0:
            return out
        n_blocks = -(-len(aff) // block)
        ids = torch.cat([aff, aff[:1].expand(n_blocks * block - len(aff))])
        for b in range(n_blocks):
            bid = ids[b * block:(b + 1) * block]
            out[bid.long()] = rows_fn(bid)
        return out
    if mode != "global":
        raise ValueError(f"repair mode {mode!r}: 'global' or 'local'")
    out = torch.empty_like(state.adjacency)
    for lo in range(0, N, block):
        bid = torch.arange(lo, lo + block, dtype=torch.int32,
                           device=dev).clamp(max=N - 1)
        out[lo:lo + block] = rows_fn(bid)[:min(block, N - lo)]
    return out


def _repair_block(adjacency, backend, deleted, usable, node_ids, alpha, R,
                  cap=None, use_kernel=False):
    """The plain block engine: assemble each node's candidates (kept live
    edges, then the rows of its deleted neighbours -- all of them, or the
    first ``cap`` in column order), prune them, keep the old row where the
    node is dead or untouched."""
    rows = adjacency[node_ids.long()]                       # [B, R]
    nbr_del = _nbr_deleted(rows, deleted)
    keep = torch.where(nbr_del | (rows < 0), torch.full_like(rows, INVALID),
                       rows)
    if cap is None:
        parents, take = rows, nbr_del
    else:
        idx, take = first_deleted(nbr_del, cap)
        parents = rows.gather(1, idx)
    exp = adjacency[parents.clamp(min=0).long()]             # [B, E, R]
    exp = torch.where(take[:, :, None], exp, torch.full_like(exp, INVALID))
    cand = torch.cat([keep, exp.reshape(rows.shape[0], -1)], 1)
    new = prune_node_batch(backend, node_ids, cand, usable, alpha=alpha,
                           R=R, use_kernel=use_kernel).ids
    changed = usable[node_ids.long()] & nbr_del.any(1)
    return torch.where(changed[:, None], new, rows)


def consolidate_deletes(state: GraphState, cfg: IndexConfig,
                        block: int = 256,
                        prune_table: torch.Tensor | None = None,
                        mode: str | None = None) -> GraphState:
    """Algorithm 4 (global or local sweep), then slot reclamation.

    prune_table: the distance table of RobustPrune -- the full-precision
    vectors by default; the StreamingMerge Delete phase passes the
    PQ-decoded vectors (paper §5.3).  mode: "global" | "local" (None ->
    ``cfg.repair_mode``)."""
    table = (state.vectors if prune_table is None else prune_table).float()
    usable = state.active & ~state.deleted
    if cfg.kernel_enabled(state.device):
        table = table.contiguous()

        def rows_fn(ids):
            return ops.delete_repair_fp(state.adjacency, state.deleted,
                                        usable, table, ids, alpha=cfg.alpha,
                                        R=cfg.R)
    else:
        backend = FullPrecisionPrune(table)

        def rows_fn(ids):
            return _repair_block(state.adjacency, backend, state.deleted,
                                 usable, ids, cfg.alpha, cfg.R)
    adjacency = _sweep(state, rows_fn, block,
                       cfg.repair_mode if mode is None else mode, usable)
    return _finish_consolidate(state, adjacency)


def consolidate_deletes_codes(state: GraphState, cfg: IndexConfig,
                              codes: torch.Tensor, tables: torch.Tensor,
                              block: int = 1024, cap: int = 8,
                              mode: str | None = None) -> GraphState:
    """Algorithm 4 with SDC distances from PQ ``codes`` [N, m] and
    ``tables`` [m, ksub, ksub], expanding at most ``cap`` deleted
    neighbours per node (the StreamingMerge Delete phase under
    ``use_sdc``)."""
    usable = state.active & ~state.deleted
    tables = tables.float().contiguous()
    if cfg.kernel_enabled(state.device):
        def rows_fn(ids):
            return ops.delete_repair_sdc(state.adjacency, state.deleted,
                                         usable, codes, tables, ids,
                                         alpha=cfg.alpha, R=cfg.R, cap=cap)
    else:
        backend = SDCPrune(codes, tables)

        def rows_fn(ids):
            return _repair_block(state.adjacency, backend, state.deleted,
                                 usable, ids, cfg.alpha, cfg.R, cap=cap)
    adjacency = _sweep(state, rows_fn, block,
                       cfg.repair_mode if mode is None else mode, usable)
    return _finish_consolidate(state, adjacency)


# Naive baselines of paper §3.3 (Figure 1's quality collapse).

def consolidate_policy_a(state: GraphState) -> GraphState:
    """Delete Policy A: drop every edge into a deleted node, add nothing."""
    nbr_del = _nbr_deleted(state.adjacency, state.deleted)
    adjacency = torch.where(nbr_del, torch.full_like(state.adjacency,
                                                     INVALID),
                            state.adjacency)
    return _finish_consolidate(state, adjacency)


def consolidate_policy_b(state: GraphState, cfg: IndexConfig,
                         block: int = 256) -> GraphState:
    """Delete Policy B: local patching with the aggressive alpha = 1
    prune."""
    return consolidate_deletes(state, dataclasses.replace(cfg, alpha=1.0),
                               block=block)
