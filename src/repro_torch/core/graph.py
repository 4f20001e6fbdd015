"""Graph state for FreshVamana indices (PyTorch port of ``core/graph.py``).

The index is a fixed-capacity structure of dense tensors on one device:
  vectors   f32[capacity, dim]   point coordinates
  adjacency i32[capacity, R]     out-neighbours, INVALID (-1) padded
  active    bool[capacity]       slot holds a live point
  deleted   bool[capacity]       lazy-delete list membership (DeleteList)
  start     i32 scalar           entry point (medoid)
  n_total   i32 scalar           allocated slots

Filtered and multi-tenant search keeps per-point labels on the host, as
numpy side tables row-parallel to each tier's external-id table
(``LabelTable``); a ``FilterSpec`` becomes a drop mask after the search
(``filter_match``), so no kernel sees a label.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import IndexConfig
from .distance import INVALID, l2_sq_batch


class GraphState(NamedTuple):
    vectors: torch.Tensor     # [capacity, dim]
    adjacency: torch.Tensor   # [capacity, R] int32
    active: torch.Tensor      # [capacity] bool
    deleted: torch.Tensor     # [capacity] bool
    start: torch.Tensor       # scalar int32
    n_total: torch.Tensor     # scalar int32

    @property
    def capacity(self) -> int:
        return self.vectors.shape[-2]

    @property
    def R(self) -> int:
        return self.adjacency.shape[-1]

    @property
    def dim(self) -> int:
        return self.vectors.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def empty_graph(cfg: IndexConfig, device) -> GraphState:
    return GraphState(
        vectors=torch.zeros((cfg.capacity, cfg.dim),
                            dtype=getattr(torch, cfg.dtype), device=device),
        adjacency=torch.full((cfg.capacity, cfg.R), INVALID,
                             dtype=torch.int32, device=device),
        active=torch.zeros(cfg.capacity, dtype=torch.bool, device=device),
        deleted=torch.zeros(cfg.capacity, dtype=torch.bool, device=device),
        start=torch.zeros((), dtype=torch.int32, device=device),
        n_total=torch.zeros((), dtype=torch.int32, device=device),
    )


def pad_graph(state: GraphState, capacity: int) -> GraphState:
    """Grow a graph to ``capacity`` slots (new slots inert: inactive,
    INVALID-adjacent, zero vectors)."""
    if state.capacity == capacity:
        return state
    if state.capacity > capacity:
        raise ValueError(f"cannot shrink graph {state.capacity} -> {capacity}")
    extra = capacity - state.capacity
    dev = state.device
    return state._replace(
        vectors=torch.cat([state.vectors, state.vectors.new_zeros(
            (extra, state.dim))]),
        adjacency=torch.cat([state.adjacency, torch.full(
            (extra, state.R), INVALID, dtype=torch.int32, device=dev)]),
        active=torch.cat([state.active, torch.zeros(
            extra, dtype=torch.bool, device=dev)]),
        deleted=torch.cat([state.deleted, torch.zeros(
            extra, dtype=torch.bool, device=dev)]),
    )


def stack_graphs(states: list[GraphState]) -> GraphState:
    """Stack graphs on a new leading tier axis, padding each to the largest
    capacity: a GraphState of [T, ...] tensors."""
    cap = max(s.capacity for s in states)
    padded = [pad_graph(s, cap) for s in states]
    return GraphState(*(torch.stack(xs) for xs in zip(*padded)))


class LaneStack(NamedTuple):
    """The §5.2 query fan-out's lanes: the temp tiers stacked at the
    largest temp capacity (``temps``, [Tt, ...] tensors, searched with exact
    L2) and the LTI graph at its own capacity with its PQ ``codes`` and
    ``codebook`` centroids (searched with ADC).  Either group may be None.
    """

    temps: Optional[GraphState]
    lti: Optional[GraphState]
    codes: Optional[torch.Tensor]      # [lti_capacity, m] uint8
    codebook: Optional[torch.Tensor]   # [m, ksub, dsub] f32

    @property
    def n_temp_lanes(self) -> int:
        return 0 if self.temps is None else self.temps.active.shape[0]

    @property
    def n_lanes(self) -> int:
        return self.n_temp_lanes + (0 if self.lti is None else 1)


def stack_lanes(temp_states: list[GraphState], *,
                lti: Optional[GraphState] = None,
                codes: Optional[torch.Tensor] = None,
                codebook: Optional[torch.Tensor] = None) -> LaneStack:
    """Stack the temp tiers (padded to the largest TEMP capacity) and attach
    the optional PQ-navigated LTI lane at its own capacity."""
    stacked = stack_graphs(temp_states) if temp_states else None
    if lti is not None:
        if codes is None or codebook is None:
            raise ValueError("lti lane set but codes/codebook missing")
        if codes.shape[0] != lti.capacity:
            raise ValueError(
                f"PQ codes cover {codes.shape[0]} slots but the LTI "
                f"capacity is {lti.capacity}")
        codebook = codebook.float()
    else:
        codes = codebook = None
    return LaneStack(stacked, lti, codes, codebook)


def shard_lti(graph: GraphState, codes: torch.Tensor, n_shards: int, *,
              devices=None) -> tuple[list[GraphState], list[torch.Tensor]]:
    """Row-partition the LTI graph and its PQ codes over ``n_shards``.

    Pads the capacity up to a multiple of ``n_shards`` (``pad_graph``:
    padding slots are inert, and their codes zero) and splits it into equal
    contiguous row blocks, shard s owning slots ``[s*cap/n, (s+1)*cap/n)``
    (``distributed.sharding.place_lti_lane``).  ``devices`` places shard s
    on ``devices[s]``; by default every block stays on the graph's device,
    where the blocks are views (no copy unless the capacity was padded).
    The entry point and the watermark ride with every block.  The sharded
    lane (``serving.steps.make_sharded_unified_step``) consumes this layout,
    with results equal to the unsharded lane's for any shard count.
    """
    from ..distributed.sharding import place_lti_lane
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    cap = -(-graph.capacity // n_shards) * n_shards
    graph = pad_graph(graph, cap)
    if codes.shape[0] < cap:
        codes = torch.cat([codes, codes.new_zeros(
            (cap - codes.shape[0], codes.shape[1]))])
    if devices is None:
        devices = [graph.device] * n_shards
    return place_lti_lane(devices, graph, codes)


NO_TENANT = -1


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """A query-time predicate over per-point labels and the tenant id.

    A point matches when it carries every ``all_of`` bit, at least one
    ``any_of`` bit (if any are given) and, with ``tenant`` set, was inserted
    under that tenant.  Frozen and hashable: it keys the system's
    filtered-mask cache and rides scheduler tickets.  An empty spec matches
    everything."""
    all_of: tuple[int, ...] = ()
    any_of: tuple[int, ...] = ()
    tenant: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "all_of", tuple(sorted(self.all_of)))
        object.__setattr__(self, "any_of", tuple(sorted(self.any_of)))

    @property
    def is_empty(self) -> bool:
        return not self.all_of and not self.any_of and self.tenant is None


class LabelTable:
    """Packed label bitsets and tenant ids of one tier's slots.

    ``bits``   uint32 [capacity, n_words]: bit ``b`` of word ``b // 32`` set
               when the point in the slot carries label ``b``;
    ``tenant`` int32 [capacity]: the owning tenant, ``NO_TENANT`` (-1) for
               none.

    The system edits it in place on flushes and replaces it by a copy on
    merges and consolidations, always beside the matching ext-id table."""

    __slots__ = ("bits", "tenant")

    def __init__(self, capacity: int, n_words: int,
                 bits: Optional[np.ndarray] = None,
                 tenant: Optional[np.ndarray] = None):
        self.bits = (np.zeros((capacity, n_words), np.uint32)
                     if bits is None else np.asarray(bits, np.uint32))
        self.tenant = (np.full(capacity, NO_TENANT, np.int32)
                       if tenant is None else np.asarray(tenant, np.int32))

    @property
    def capacity(self) -> int:
        return self.bits.shape[0]

    @property
    def n_words(self) -> int:
        return self.bits.shape[1]

    def copy(self) -> "LabelTable":
        return LabelTable(self.capacity, self.n_words, self.bits.copy(),
                          self.tenant.copy())

    def set_row(self, slot: int, bits_row: np.ndarray, tenant: int) -> None:
        self.bits[slot] = bits_row
        self.tenant[slot] = tenant

    def clear_rows(self, mask_or_slots) -> None:
        self.bits[mask_or_slots] = 0
        self.tenant[mask_or_slots] = NO_TENANT

    def grow(self, capacity: int) -> "LabelTable":
        if capacity == self.capacity:
            return self
        if capacity < self.capacity:
            raise ValueError(
                f"cannot shrink label table {self.capacity} -> {capacity}")
        out = LabelTable(capacity, self.n_words)
        out.bits[:self.capacity] = self.bits
        out.tenant[:self.capacity] = self.tenant
        return out


def pack_labels(labels, n_words: int) -> np.ndarray:
    """Pack an iterable of label bit indices into a uint32 [n_words] row."""
    row = np.zeros(n_words, np.uint32)
    for b in labels or ():
        b = int(b)
        if not 0 <= b < 32 * n_words:
            raise ValueError(
                f"label bit {b} out of range for {n_words} words "
                f"(cfg.filter_words covers bits [0, {32 * n_words}))")
        row[b // 32] |= np.uint32(1 << (b % 32))
    return row


def unpack_labels(row: np.ndarray) -> list[int]:
    """The sorted label bit indices set in a packed uint32 row (the inverse
    of ``pack_labels``; WAL replay turns stored rows back into labels)."""
    out = []
    for w, word in enumerate(np.asarray(row, np.uint32)):
        word = int(word)
        while word:
            low = word & -word
            out.append(32 * w + low.bit_length() - 1)
            word ^= low
    return out


def filter_match(table: LabelTable, spec: FilterSpec) -> np.ndarray:
    """bool [capacity]: which slots satisfy ``spec`` (an empty spec matches
    all).  Liveness is not consulted: the caller ORs ``~match`` into the
    DeleteList drop mask, which covers it."""
    match = np.ones(table.capacity, bool)
    if spec.tenant is not None:
        match &= table.tenant == spec.tenant
    if spec.all_of:
        want = pack_labels(spec.all_of, table.n_words)
        match &= ((table.bits & want) == want).all(axis=1)
    if spec.any_of:
        want = pack_labels(spec.any_of, table.n_words)
        match &= (table.bits & want).any(axis=1)
    return match


def medoid(vectors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Index of the point nearest the masked mean (the entry point); the
    first such index on ties, as ``jnp.argmin``."""
    m = mask.float()
    mean = (vectors * m[:, None]).sum(0) / m.sum().clamp(min=1.0)
    d = l2_sq_batch(mean[None, :], vectors)[0]
    d = torch.where(mask, d, torch.full_like(d, float("inf")))
    return torch.argmin(d).to(torch.int32)
