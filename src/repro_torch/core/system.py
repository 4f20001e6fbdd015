"""The FreshDiskANN system (paper §5): LTI + RW/RO TempIndex + DeleteList
with the StreamingMerge cycle, PyTorch port of ``core/system.py``.

It runs: the bootstrap build of the LTI, streaming inserts buffered and
flushed into the RW TempIndex (in arrival order, or proximity-ordered with
``locality_order``), RW -> RO rollover, deletes into the DeleteList,
``search_batch`` through the one-call §5.2 fan-out
(``index.unified_search``) with ``batch_queries`` chunking, and
StreamingMerge of the RO tiers and the DeleteList into the LTI -- on
reaching ``merge_threshold`` (on a worker thread with
``background_merge``) or on ``merge()`` -- plus the standalone
``consolidate()``.  Everything lives on one device (CUDA unless the caller
asks for the CPU).

Durability and the storage tier (paper §5.1, §5.6):

* ``wal_dir``: every insert and delete is appended to the redo log
  (``core/wal.py``) before it is applied; ``recover()`` loads the newest
  snapshot and replays the log suffix past it.
* ``snapshot_dir``: each merge snapshots the system (``save``) before it
  truncates the log into a new epoch; without it the log is never
  truncated.  Snapshots use the reference's files and are readable by
  either package: the port pickles only builtins and numpy arrays, and
  reads the reference's pickles without importing it.
* ``storage_dir``: the LTI is mirrored to the decoupled on-disk layout
  (``storage/layout.py``), written whole at construction and delta-patched
  after every merge and consolidation; ``search_disk`` serves the LTI lane
  off that layout (``storage.DiskLTISearcher``) and the temp tiers from
  memory.

A merge builds a NEW LTI (``merge.streaming_merge`` writes only copies)
while searches read the old one; the (LTI, external-id table) pair is
swapped as one tuple once the merge's device work has finished, and the RO
snapshots it consumed leave ``self.ro`` only after that swap, so a search
racing a merge sees every point in one whole generation (or briefly in two,
which the cross-tier dedupe resolves).  The reference's locks keep their
canonical order: ``_flush_lock`` -> ``_insert_lock`` -> ``_ro_lock``, and
``_merge_lock`` around merges and consolidations.

Serving knobs (paper §5.2, §6.2):

* ``shard_lti``: the LTI lane's arrays row-sharded over a device group
  (``serving.steps``), with results equal to the unsharded lane's; capped
  at the CUDA device count on the card, uncapped on the CPU, where every
  shard is the host (``distributed.sharding``).
* ``batch_fanout=False``: the sequential per-tier query path, one search
  per tier and a host-side aggregation -- the oracle the unified fan-out
  is held to.
* ``autotune_beam``: W calibrated from the hop/cmp counters of a probe
  (``core.autotune``), cached until the next merge or consolidation.

``serving.BatchScheduler`` and ``serving.ReplicaSet`` sit in front of
``search_batch``.

Filtered and multi-tenant search: ``insert(labels=, tenant=)`` and
``bootstrap_system(labels=, tenants=)`` tag points with label bits
(``filter_words`` uint32 words a point) and a tenant id.  Every tier keeps
a host-side ``graph.LabelTable`` beside its ext-id table, and the labels
follow a point through the WAL (op-2 records), the insert buffer, flushes,
rollover, merges, consolidation, snapshots and the layout's side tables.
``search_batch(filter=)`` and ``search_disk(filter=)`` take a
``graph.FilterSpec``: it is folded into the DeleteList drop mask that the
fan-out applies after the beam search, so hops and cmps never change and a
spec every live point matches returns the unfiltered result.

External ids are user-provided int64s; the system maps them to
(tier, slot).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import autotune
from . import index as mem
from . import pq as pqm
from .config import SystemConfig, resolve_device
from .delete import affected_mask, consolidate_deletes
from .distance import INVALID
from .graph import (NO_TENANT, FilterSpec, GraphState, LabelTable,
                    empty_graph, filter_match, pack_labels, pad_graph,
                    stack_lanes, unpack_labels)
from .locality import locality_order
from .lti import LTIState, build_lti, search_lti
from .merge import adjacency_delta_mask, streaming_merge
from .reach import unreachable_fraction
from .wal import (OP_DELETE, OP_INSERT, OP_INSERT_LABELED, WriteAheadLog,
                  log_epoch, replay)
from ..storage import (DiskLTISearcher, is_layout, open_layout,
                       patch_layout, write_layout)
from ..storage.layout import host

@dataclass
class _Temp:
    """One TempIndex instance + its slot -> external-id map and labels."""
    state: GraphState
    ext_ids: np.ndarray           # [capacity] int64, -1 free
    labels: LabelTable            # row-parallel to ext_ids
    n: int = 0


LATENCY_RESERVOIR = 1024


class Reservoir:
    """Fixed-size uniform sample of an unbounded stream (Vitter's algorithm
    R) with percentile snapshots; exact while ``seen <= size``."""

    def __init__(self, size: int = LATENCY_RESERVOIR, seed: int = 0):
        self.size = size
        self.sample: list = []
        self.seen = 0
        self._rng = np.random.default_rng(seed)

    def record(self, x: float) -> None:
        self.seen += 1
        if len(self.sample) < self.size:
            self.sample.append(x)
        else:
            j = int(self._rng.integers(self.seen))
            if j < self.size:
                self.sample[j] = x

    def percentile(self, p: float) -> float:
        """Linear-interpolated percentile of the sample (NaN when empty)."""
        if not self.sample:
            return float("nan")
        return float(np.percentile(self.sample, p))

    def snapshot(self) -> dict:
        return {"p50": self.percentile(50.0), "p99": self.percentile(99.0),
                "n": self.seen}


@dataclass
class SystemStats:
    """The reference's counters that the ported paths update (same names
    and meanings)."""
    inserts: int = 0
    deletes: int = 0
    searches: int = 0            # queries served
    merges: int = 0
    snapshots: int = 0           # RW -> RO rollovers
    merge_seconds: float = 0.0
    search_dispatches: int = 0   # unified fan-out calls (one per micro-batch)
    local_repairs: int = 0       # Delete phases run as the affected-set sweep
    global_repairs: int = 0      # Delete phases run as the global sweep
    consolidations: int = 0      # standalone consolidate() calls
    repair_cap_overflows: int = 0  # SDC repairs past merge.SDC_REPAIR_CAP
    reach_probes: int = 0        # reachability probes run
    repair_escalations: int = 0  # local repairs whose probe forced the next
    #   Delete phase global
    unreachable_frac: float = 0.0  # gauge: the latest probe's estimate
    flushes: int = 0
    flush_backedge_targets: int = 0  # distinct Delta targets across flushes
    merge_backedge_targets: int = 0  # distinct Delta targets across merges
    merge_prune_rows: int = 0    # rows merge Patch phases sent to the prune
    #   engine (MergeStats.n_prune_rows: what the port launched)
    merge_phase_seconds: dict = field(default_factory=dict)  # port only:
    #   seconds per merge phase ("delete", "insert", "patch") summed over
    #   merges, the device synchronized at each phase boundary, and, with
    #   storage_dir and snapshot_dir, the layout patch ("layout_patch") and
    #   the snapshot before the log truncation ("snapshot")
    # Storage tier (cfg.storage_dir).  Rows obey the conservation law
    # io_rows_read + io_cache_hits == rows the engine requested.
    io_rows_read: int = 0        # adjacency rows read off topology.bin
    #   (demand reads + prefetch-staged reads: the engine's n_reads)
    io_cache_hits: int = 0       # rows the block cache served, no file IO
    io_prefetch_hits: int = 0    # ... of io_rows_read, staged ahead
    io_bytes_read: int = 0       # topology.bin bytes read (whole blocks)
    storage_rows_patched: int = 0    # adjacency rows the delta patches wrote
    storage_blocks_patched: int = 0  # distinct 4 KB blocks of those rows
    storage_bytes_written: int = 0   # bytes of patches and full writes
    # The serving front end (serving/scheduler.py), updated under the
    # scheduler's lock.
    scheduled_requests: int = 0  # requests admitted to the serving queue
    shed_requests: int = 0       # requests rejected by the bounded queue
    batches_dispatched: int = 0  # micro-batches the scheduler served
    deadline_misses: int = 0     # requests completed after arrival + slo_ms
    queue_depth: int = 0         # gauge: pending requests after the last
    #   submit or close
    batch_occupancy: float = 0.0  # gauge: fill (n / batch_queries) of the
    #   last dispatched micro-batch
    # Filtered and multi-tenant search.
    filtered_searches: int = 0   # queries served under a non-empty spec
    tenant_searches: dict = field(default_factory=dict)  # tenant id ->
    #   queries served under that tenant's filter
    tenant_sheds: dict = field(default_factory=dict)     # tenant id ->
    #   submissions shed by the per-tenant quota (cfg.tenant_quota); each
    #   also counts in shed_requests
    # Latency reservoirs: insert_latency per insert() (the lock-held
    # append), flush_latency per flush, search_latency per dispatched
    # micro-batch, serve_latency per scheduled request (arrival ->
    # completion on the scheduler's clock).
    insert_latency: Reservoir = field(default_factory=Reservoir, repr=False)
    search_latency: Reservoir = field(
        default_factory=lambda: Reservoir(seed=1), repr=False)
    serve_latency: Reservoir = field(
        default_factory=lambda: Reservoir(seed=2), repr=False)
    flush_latency: Reservoir = field(
        default_factory=lambda: Reservoir(seed=3), repr=False)

    def record_latency(self, seconds: float) -> None:
        self.insert_latency.record(seconds)

    def serving_snapshot(self) -> dict:
        """p50/p99 of each latency reservoir and the queue, batch, filter
        and tenant counters, as the reference reports them."""
        return {
            "search": self.search_latency.snapshot(),
            "serve": self.serve_latency.snapshot(),
            "insert": self.insert_latency.snapshot(),
            "flush": self.flush_latency.snapshot(),
            "flushes": self.flushes,
            "scheduled_requests": self.scheduled_requests,
            "shed_requests": self.shed_requests,
            "batches_dispatched": self.batches_dispatched,
            "deadline_misses": self.deadline_misses,
            "queue_depth": self.queue_depth,
            "batch_occupancy": self.batch_occupancy,
            "filtered_searches": self.filtered_searches,
            "tenant_searches": dict(self.tenant_searches),
            "tenant_sheds": dict(self.tenant_sheds),
        }


class FreshDiskANN:
    def __init__(self, cfg: SystemConfig, lti: Optional[LTIState] = None,
                 lti_ext_ids: Optional[np.ndarray] = None, device="cuda",
                 lti_labels: Optional[LabelTable] = None):
        """``lti_labels`` tags the given LTI's slots (default: no labels,
        no tenants); it is in place before the layout of ``storage_dir``
        is first written."""
        self.cfg = cfg
        self.device = resolve_device(device)
        icfg = cfg.index
        # Everything but capacity mirrors the LTI's config (one IndexConfig
        # drives every lane of the fan-out).
        self.temp_cfg = dataclasses.replace(icfg,
                                            capacity=cfg.temp_capacity)
        if lti is None:
            lti = LTIState(
                empty_graph(icfg, self.device),
                torch.zeros((icfg.capacity, cfg.pq.m), dtype=torch.uint8,
                            device=self.device),
                pqm.PQCodebook(torch.zeros(
                    (cfg.pq.m, cfg.pq.ksub, cfg.pq.dsub),
                    device=self.device)))
        # The LTI, its ext-id table and its label table are read and
        # swapped as one tuple: a search racing a merge never mixes
        # generations.
        self._n_label_words = cfg.filter_words
        self._lti_pair: tuple[LTIState, np.ndarray, LabelTable] = (
            lti, lti_ext_ids if lti_ext_ids is not None
            else np.full(icfg.capacity, -1, np.int64),
            lti_labels if lti_labels is not None
            else LabelTable(icfg.capacity, cfg.filter_words))
        self.rw = self._new_temp()
        self.ro: list[_Temp] = []
        self.deleted_ext: set[int] = set()
        self._ext_loc: dict[int, tuple] = {}
        if lti_ext_ids is not None:
            for slot in np.nonzero(lti_ext_ids >= 0)[0]:
                self._ext_loc[int(lti_ext_ids[slot])] = ("lti", int(slot))
        self._insert_buf_v: list[np.ndarray] = []
        self._insert_buf_id: list[int] = []
        self._insert_buf_bits: list[np.ndarray] = []   # packed label rows
        self._insert_buf_tenant: list[int] = []        # NO_TENANT default
        self.stats = SystemStats()
        self._merge_lock = threading.Lock()
        self._ro_lock = threading.Lock()      # guards self.ro
        # Guards the insert buffer and the RW bookkeeping (buffer append and
        # swap, DeleteList edits, ext-id maps); the flush compute runs under
        # _flush_lock only.  Canonical order: _flush_lock -> _insert_lock ->
        # _ro_lock.
        self._insert_lock = threading.RLock()
        self._flush_lock = threading.RLock()
        self._flush_seq = 0                   # locality-order seed per flush
        self._merge_inflight = 0              # staged points being merged
        self._merge_thread: Optional[threading.Thread] = None
        self._force_global_repair = False     # set by a reachability probe
        self._reach_baseline: Optional[float] = None
        self._tuned_w: Optional[int] = None   # cached autotuned beam width
        # Sharded-lane caches (cfg.shard_lti, see _sharded_program).
        self._shard_group: Optional[list] = None
        self._shard_place: Optional[tuple] = None
        self._shard_steps: dict = {}
        # Fan-out caches keyed by tier-state identity (a flush, rollover or
        # merge replaces the state object) and, for the drop masks, the
        # DeleteList epoch (bumped on every DeleteList change).  The
        # filtered masks: (key, epoch, {FilterSpec: masks}).
        self._fanout_cache: Optional[tuple] = None
        self._drop_cache: Optional[tuple] = None
        self._filter_cache: Optional[tuple] = None
        self._delete_epoch = 0
        self._wal_offset: Optional[int] = None  # WAL bytes a snapshot covers
        self._wal_epoch: Optional[int] = None   # ... and of which log epoch
        self.wal: Optional[WriteAheadLog] = None
        if cfg.wal_dir:
            os.makedirs(cfg.wal_dir, exist_ok=True)
            self.wal = WriteAheadLog(
                os.path.join(cfg.wal_dir, "wal.bin"), icfg.dim)
        # The live layout mirrors the LTI; the searcher over it is cached
        # per layout generation (a sync closes it, reopened lazily).
        self._disk_searcher: Optional[DiskLTISearcher] = None
        if cfg.storage_dir:
            self._sync_storage()

    @property
    def lti(self) -> LTIState:
        return self._lti_pair[0]

    @property
    def lti_ext_ids(self) -> np.ndarray:
        return self._lti_pair[1]

    @property
    def lti_labels(self) -> LabelTable:
        return self._lti_pair[2]

    @lti_labels.setter
    def lti_labels(self, value: LabelTable) -> None:
        self._lti_pair = (self._lti_pair[0], self._lti_pair[1], value)

    # ------------------------------------------------------------------ API
    def insert(self, ext_id: int, vec: np.ndarray, labels=None,
               tenant: Optional[int] = None) -> None:
        """Route to the RW TempIndex (paper §5.2); batched flush.
        ``labels`` (label bit indices, packed into ``cfg.filter_words``
        words) and ``tenant`` tag the point; they ride the WAL as a
        labelled-insert record (op 2) and follow the point into every
        tier's label table."""
        bits = pack_labels(labels, self._n_label_words) if labels else None
        ten = NO_TENANT if tenant is None else int(tenant)
        t0 = time.perf_counter()
        with self._insert_lock:
            if self.wal:
                if bits is not None or ten != NO_TENANT:
                    self.wal.log_insert_labeled(
                        ext_id, vec, ten, bits if bits is not None else
                        np.zeros(self._n_label_words, np.uint32))
                else:
                    self.wal.log_insert(ext_id, vec)
            self._insert_buf_id.append(int(ext_id))
            self._insert_buf_v.append(np.asarray(vec, np.float32))
            self._insert_buf_bits.append(
                bits if bits is not None else
                np.zeros(self._n_label_words, np.uint32))
            self._insert_buf_tenant.append(ten)
            # A re-insert revives the id at once (not at flush time).
            if int(ext_id) in self.deleted_ext:
                self.deleted_ext.discard(int(ext_id))
                self._delete_epoch += 1
            full = len(self._insert_buf_id) >= self.cfg.insert_batch
        self.stats.inserts += 1
        self.stats.record_latency(time.perf_counter() - t0)
        if full:
            self._flush_inserts()
        self._maybe_rollover()

    def delete(self, ext_id: int) -> None:
        """DeleteList append -- no graph edits (paper §4.2)."""
        e = int(ext_id)
        with self._insert_lock:
            if self.wal:
                self.wal.log_delete(ext_id)
            if e in self._insert_buf_id:
                # Only buffered: drop it there, or the next flush would
                # revive it and invert the op order.
                keep = [i for i, x in enumerate(self._insert_buf_id)
                        if x != e]
                self._insert_buf_id = [self._insert_buf_id[i] for i in keep]
                self._insert_buf_v = [self._insert_buf_v[i] for i in keep]
                self._insert_buf_bits = [self._insert_buf_bits[i]
                                         for i in keep]
                self._insert_buf_tenant = [self._insert_buf_tenant[i]
                                           for i in keep]
            self.deleted_ext.add(e)
            self._delete_epoch += 1
        self.stats.deletes += 1

    def search(self, queries: np.ndarray, k: int, L: Optional[int] = None,
               beam_width: Optional[int] = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Alias for ``search_batch``."""
        return self.search_batch(queries, k, L=L, beam_width=beam_width)

    def search_batch(self, queries: np.ndarray, k: int,
                     L: Optional[int] = None,
                     beam_width: Optional[int] = None,
                     filter: Optional[FilterSpec] = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Serve a query batch over the LTI and every TempIndex, drop the
        DeleteList, merge (§5.2).  Returns (ext_ids [B, k] int64,
        dists [B, k] f32).  ``cfg.batch_queries`` = N > 0 serves the batch
        in fixed chunks of N queries (the tail zero-padded and sliced off);
        ``stats.search_dispatches`` counts the chunks.

        ``filter`` keeps only points matching a ``FilterSpec``: it is
        applied after the search, where deletes are, so a client asking for
        a rare label widens k and L.  An empty spec is no filter."""
        self._flush_inserts()
        fspec = self._resolve_filter(filter)
        L = L or self.cfg.index.L_search
        if k > L:
            raise ValueError(
                f"search(k={k}, L={L}): k must be <= L -- the candidate list "
                f"holds only L entries; raise L or lower k")
        W = beam_width or self._beam_width(queries)
        kk = min(max(k * 2, k + 8), L)    # over-fetch for drops and dedupe
        q = np.asarray(queries, np.float32)
        B = q.shape[0]
        self._count_searches(B, fspec)
        if B == 0:
            return (np.zeros((0, k), np.int64), np.zeros((0, k), np.float32))
        bq = self.cfg.batch_queries
        if not bq or B == bq:
            return self._search_dispatch(q, k, kk, L, W, fspec)
        outs = []
        for lo in range(0, B, bq):
            chunk = q[lo:lo + bq]
            n = len(chunk)
            if n < bq:
                qp = np.zeros((bq, q.shape[1]), np.float32)
                qp[:n] = chunk
                chunk = qp
            ids, d = self._search_dispatch(chunk, k, kk, L, W, fspec)
            outs.append((ids[:n], d[:n]))
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))

    @staticmethod
    def _resolve_filter(spec: Optional[FilterSpec]) -> Optional[FilterSpec]:
        """None for no filter or an empty spec (the unfiltered path)."""
        return spec if spec is not None and not spec.is_empty else None

    def _count_searches(self, n: int, fspec: Optional[FilterSpec]) -> None:
        """Queries served, filtered and per tenant (queries, not
        programs)."""
        self.stats.searches += n
        if fspec is not None:
            self.stats.filtered_searches += n
            if fspec.tenant is not None:
                self.stats.tenant_searches[fspec.tenant] = (
                    self.stats.tenant_searches.get(fspec.tenant, 0) + n)

    # -------------------------------------------------------------- merging
    def merge(self, background: bool = False) -> None:
        """StreamingMerge the RO TempIndex points and the DeleteList into
        the LTI (on a worker thread with ``background``; a merge already
        running there makes this a no-op)."""
        if background:
            if self._merge_thread and self._merge_thread.is_alive():
                return
            self._merge_thread = threading.Thread(target=self._merge_impl)
            self._merge_thread.start()
        else:
            self._merge_impl()

    def wait_merge(self) -> None:
        if self._merge_thread:
            self._merge_thread.join()

    def _merge_impl(self) -> None:
        with self._merge_lock:
            t0 = time.perf_counter()
            # The RO tiers stay searchable while the merge runs: they leave
            # self.ro only after the new LTI holding their points is in.
            with self._ro_lock:
                ro = list(self.ro)
                self._merge_inflight = sum(t.n for t in ro)
            try:
                self._merge_body(ro, t0)
            finally:
                self._merge_inflight = 0

    def _sync_device(self) -> None:
        """Wait for this thread's device work (before a generation swap)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _merge_body(self, ro: list, t0: float) -> None:
        staged = sum(t.n for t in ro)
        icfg = self.cfg.index
        # The pre-merge adjacency anchors the layout's delta patch.
        old_adj = self.lti.graph.adjacency if self.cfg.storage_dir else None
        del_snapshot = set(self.deleted_ext)
        dl = np.fromiter(del_snapshot, np.int64, len(del_snapshot))
        # Stage the RO points in tier and slot order, minus re-deleted ones;
        # their labels follow them.
        parts_v, parts_e, parts_b, parts_t = [], [], [], []
        for t in ro:
            sl = np.nonzero(t.ext_ids >= 0)[0][:t.n]
            ext = t.ext_ids[sl]
            keep = ~np.isin(ext, dl)
            parts_v.append(t.state.vectors[torch.as_tensor(
                sl[keep]).to(self.device)])
            parts_e.append(ext[keep])
            parts_b.append(t.labels.bits[sl[keep]])
            parts_t.append(t.labels.tenant[sl[keep]])
        w = sum(len(e) for e in parts_e)
        nn = max(staged, 1)
        vecs = torch.zeros((nn, icfg.dim), device=self.device)
        exts = np.full(nn, -1, np.int64)
        sbits = np.zeros((nn, self._n_label_words), np.uint32)
        sten = np.full(nn, NO_TENANT, np.int32)
        if w:
            vecs[:w] = torch.cat(parts_v).float()
            exts[:w] = np.concatenate(parts_e)
            sbits[:w] = np.concatenate(parts_b)
            sten[:w] = np.concatenate(parts_t)
        valid = np.zeros(nn, bool)
        valid[:w] = True
        # Remove from the LTI the DeleteList members and the rows a staged
        # re-insert supersedes (the old copy of a deleted-then-reinserted
        # id).
        lti_ids = self.lti_ext_ids
        dmask = np.isin(lti_ids, dl)
        if w:
            dmask |= np.isin(lti_ids, exts[:w])
        repair_mode = self._pick_repair_mode(dmask)
        new_lti, stats = streaming_merge(
            self.lti, vecs, torch.as_tensor(valid).to(self.device),
            torch.as_tensor(dmask).to(self.device), icfg, self.cfg.pq,
            insert_chunk=self.cfg.insert_batch, block=self.cfg.merge_block,
            repair_mode=repair_mode, locality=self.cfg.locality_order,
            # Seeded by the merge ordinal: deterministic for its inputs,
            # and successive merges draw other medoids.
            locality_seed=self.stats.merges,
            timings=self.stats.merge_phase_seconds)
        self._sync_device()
        self.stats.repair_cap_overflows += stats.repair_cap_overflows
        self.stats.merge_backedge_targets += stats.n_backedge_targets
        self.stats.merge_prune_rows += stats.n_prune_rows
        if repair_mode == "local":
            self.stats.local_repairs += 1
        else:
            self.stats.global_repairs += 1
            self._force_global_repair = False
        # The ext-id and label tables: deleted rows out, merged rows in at
        # the slots the merge assigned.
        new_ids, new_labels = self._retire_lti_rows(dmask)
        slots = stats.slots.cpu().numpy()
        ok = valid & (slots >= 0)
        new_ids[slots[ok]] = exts[ok]
        new_labels.bits[slots[ok]] = sbits[ok]
        new_labels.tenant[slots[ok]] = sten[ok]
        for s_, e in zip(slots[ok], exts[ok]):
            self._ext_loc[int(e)] = ("lti", int(s_))
        # One generation swap (graph, ext ids, labels), then retire exactly
        # the RO snapshots merged.
        self._lti_pair = (new_lti, new_ids, new_labels)
        with self._ro_lock:
            self.ro = self.ro[len(ro):]
            self._merge_inflight = 0
        self._tuned_w = None        # the graph changed: re-calibrate W
        self._shard_place = None    # the old LTI's sharded blocks likewise
        timings = self.stats.merge_phase_seconds
        if self.cfg.storage_dir:
            # Only the adjacency rows this merge rewrote reach topology.bin.
            t1 = time.perf_counter()
            self._sync_storage(adj_changed=host(adjacency_delta_mask(
                old_adj, new_lti.graph.adjacency)))
            timings["layout_patch"] = (timings.get("layout_patch", 0.0)
                                       + time.perf_counter() - t1)
        self._retire_deletes(del_snapshot)
        if self.wal and self.cfg.snapshot_dir:
            # Snapshot BEFORE truncating (§5.6), as one step against
            # concurrent WAL writers (_flush_lock first, the canonical
            # order); the restart goes through the live handle.  Without
            # snapshot_dir the whole log is kept.
            t1 = time.perf_counter()
            with self._flush_lock, self._insert_lock:
                self._save_locked(os.path.join(
                    self.cfg.snapshot_dir, f"merge_{self.stats.merges + 1}"))
                self.wal.restart(self.stats.merges + 1)
            timings["snapshot"] = (timings.get("snapshot", 0.0)
                                   + time.perf_counter() - t1)
        self.stats.merges += 1
        self.stats.merge_seconds += time.perf_counter() - t0
        self._probe_reachability(repair_mode)

    def _retire_lti_rows(self, dmask: np.ndarray
                         ) -> tuple[np.ndarray, LabelTable]:
        """Copies of the LTI's ext-id and label tables with the ``dmask``
        rows cleared (and their ids' LTI locations forgotten)."""
        new_ids = self.lti_ext_ids.copy()
        for e in new_ids[dmask]:
            e = int(e)
            if e >= 0 and self._ext_loc.get(e, ("?",))[0] == "lti":
                del self._ext_loc[e]
        new_ids[dmask] = -1
        new_labels = self.lti_labels.copy()
        new_labels.clear_rows(dmask)
        return new_ids, new_labels

    def _retire_deletes(self, del_snapshot: set) -> None:
        """After a generation swap: a delete leaves the DeleteList only when
        no copy of its id survives anywhere (a copy in the RW tier, a newer
        RO tier or the insert buffer keeps it pending).  Drops the fan-out
        caches."""
        self._fanout_cache = None
        self._drop_cache = None
        self._filter_cache = None
        alive = self._live_ext_ids()
        dl = np.fromiter(del_snapshot, np.int64, len(del_snapshot))
        with self._insert_lock:
            self.deleted_ext -= set(dl[~np.isin(dl, alive)].tolist())
            self._delete_epoch += 1

    def _pick_repair_mode(self, dmask: np.ndarray) -> str:
        """The localized sweep when the LTI's delete rate is at most
        ``local_repair_threshold`` (and no escalation is pending), else
        the global one: both give the same graph."""
        if self._force_global_repair:
            return "global"
        if self.cfg.index.repair_mode == "local":
            return "local"
        thr = self.cfg.local_repair_threshold
        if thr <= 0:
            return "global"
        active = self.lti.graph.active.cpu().numpy()
        n_live = int(active.sum())
        n_del = int(np.count_nonzero(dmask & active))
        return "local" if n_del <= thr * max(n_live, 1) else "global"

    def _probe_reachability(self, repair_mode: str) -> None:
        """Sampled self-search of the LTI after a Delete phase: sets the
        ``unreachable_frac`` gauge and forces the next Delete phase global
        when a localized repair left the estimate more than
        ``reach_escalate_frac`` above the last global sweep's."""
        n = self.cfg.reach_probe_samples
        if n <= 0:
            return
        frac = unreachable_fraction(self._lti_pair[0].graph, self.cfg.index,
                                    samples=n, seed=self.stats.reach_probes)
        self.stats.unreachable_frac = frac
        self.stats.reach_probes += 1
        if repair_mode != "local" or self._reach_baseline is None:
            self._reach_baseline = frac
        elif frac > self._reach_baseline + self.cfg.reach_escalate_frac:
            self.stats.repair_escalations += 1
            self._force_global_repair = True

    def consolidate(self, mode: str = "local") -> int:
        """Algorithm 4 on the LTI outside a merge (on the PQ-decoded
        table, as the merge's Delete phase).  Returns the number of LTI
        points consolidated away; ids whose only copy was there leave the
        DeleteList, copies in temp tiers keep their delete pending."""
        with self._merge_lock:
            icfg = self.cfg.index
            lti, table, _ = self._lti_pair
            del_snapshot = set(self.deleted_ext)
            dl = np.fromiter(del_snapshot, np.int64, len(del_snapshot))
            dmask = np.isin(table, dl) & lti.graph.active.cpu().numpy()
            n_del = int(dmask.sum())
            if n_del == 0:
                return 0
            g = lti.graph
            g = g._replace(deleted=g.deleted | torch.as_tensor(dmask).to(
                self.device))
            # The rows that change are known beforehand: the affected rows
            # are repaired, the deleted ones cleared.  They anchor the
            # layout's delta patch.
            changed = host(affected_mask(g.adjacency, g.deleted,
                                         g.active & ~g.deleted)) | dmask
            decoded = pqm.decode(lti.codebook, lti.codes, self.cfg.pq)
            new_g = consolidate_deletes(g, icfg, block=self.cfg.merge_block,
                                        prune_table=decoded, mode=mode)
            self._sync_device()
            if mode == "local":
                self.stats.local_repairs += 1
            else:
                self.stats.global_repairs += 1
                self._force_global_repair = False
            new_ids, new_labels = self._retire_lti_rows(dmask)
            self._lti_pair = (LTIState(new_g, lti.codes, lti.codebook),
                              new_ids, new_labels)
            self._tuned_w = None
            self._shard_place = None
            if self.cfg.storage_dir:
                self._sync_storage(adj_changed=changed)
            self._retire_deletes(del_snapshot)
            self.stats.consolidations += 1
            self._probe_reachability(mode)
            return n_del

    # ---------------------------------------------------------------- query
    def _search_dispatch(self, queries, k, kk, L, W, fspec=None):
        """Timed wrapper: each dispatched micro-batch samples its wall time
        (to the results on the host) into ``stats.search_latency``."""
        d0 = self.stats.search_dispatches
        t0 = time.perf_counter()
        out = self._search_dispatch_impl(queries, k, kk, L, W, fspec)
        if self.stats.search_dispatches > d0:
            self.stats.search_latency.record(time.perf_counter() - t0)
        return out

    def _search_dispatch_impl(self, queries, k, kk, L, W, fspec=None):
        """Serve one fixed-shape micro-batch: the unified fan-out (its LTI
        lane sharded with ``shard_lti``), or with ``batch_fanout=False``
        one search per tier and the host aggregation.  A ``fspec`` only
        changes the drop masks (or, per tier, ``_slot_filter``)."""
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        nq = queries.shape[0]
        rw_t, ro_temps, lti_entry = self._capture_lanes()
        if rw_t is None and not ro_temps and lti_entry is None:
            return self._aggregate([], k, nq)
        if self.cfg.batch_fanout:
            bundle = self._lane_bundle(rw_t, ro_temps, lti_entry)
            t_drop, l_drop = self._masks(bundle, fspec)
            stack, t_tabs, l_tab = bundle[1:4]
            # The rerank only matters to the PQ lane.
            do_rerank = self.cfg.rerank and lti_entry is not None
            if lti_entry is not None and self._shard_count():
                step, sstack = self._sharded_program(
                    stack, k=k, kk=kk, L=L, W=W, rerank=do_rerank)
                ids, d, _, _ = step(sstack, t_tabs, l_tab, t_drop, l_drop,
                                    q)
            else:
                ids, d, _, _ = mem.unified_search(
                    stack, t_tabs, l_tab, t_drop, l_drop, q,
                    self.cfg.index, k=k, k_lane=kk, L=L, beam_width=W,
                    rerank=do_rerank)
            self.stats.search_dispatches += 1
            return (ids.cpu().numpy().astype(np.int64),
                    d.cpu().numpy().astype(np.float32))
        # The sequential oracle: one search per tier, host aggregation.
        cands: list[tuple[np.ndarray, np.ndarray]] = []
        if lti_entry is not None:
            ids, d, _, _ = search_lti(lti_entry[0], q, self.cfg.index, k=kk,
                                      L=L, beam_width=W,
                                      rerank=self.cfg.rerank)
            self.stats.search_dispatches += 1
            ids = host(ids)
            cands.append((self._map_ext(ids, lti_entry[1]),
                          self._slot_filter(ids, host(d), lti_entry[2],
                                            fspec)))
        for t in ([rw_t] if rw_t is not None else []) + ro_temps:
            ids, d, _, _ = mem.search(t.state, q, self.temp_cfg, k=kk, L=L,
                                      beam_width=W)
            self.stats.search_dispatches += 1
            ids = host(ids)
            cands.append((self._map_ext(ids, t.ext_ids),
                          self._slot_filter(ids, host(d), t.labels, fspec)))
        return self._aggregate(cands, k, nq)

    @staticmethod
    def _slot_filter(slot_ids: np.ndarray, dists: np.ndarray,
                     labels: Optional[LabelTable],
                     fspec: Optional[FilterSpec]) -> np.ndarray:
        """The per-tier paths' filtered drop: +inf for the candidates whose
        slot fails ``fspec``, at the point where the fan-out applies its
        masks (so the two paths stay equal with filters on).  A tier with
        no label table matches nothing."""
        if fspec is None:
            return dists
        d = dists.copy()
        ok = slot_ids >= 0
        if labels is None:
            d[ok] = np.inf
            return d
        m = filter_match(labels, fspec)
        dead = np.zeros(slot_ids.shape, bool)
        dead[ok] = ~m[slot_ids[ok]]
        d[dead] = np.inf
        return d

    # ---------------------------------------------------- sharded LTI lane
    @property
    def lti_shards(self) -> int:
        """Effective LTI-lane shard count: ``cfg.shard_lti`` capped at the
        CUDA device count on the card, uncapped on the CPU (0 =
        unsharded)."""
        return self._shard_count()

    def _shard_count(self) -> int:
        from ..distributed.sharding import census
        n = self.cfg.shard_lti
        if n <= 0:
            return 0
        cap = census(self.device)
        return n if cap is None else min(n, cap)

    def _sharded_program(self, stack, *, k, kk, L, W, rerank):
        """(step, stack with the LTI's shard blocks) for the sharded
        fan-out.  Three caches: the device group (per shard count), the
        ``graph.shard_lti`` placement (keyed by LTI graph and codes
        identity: a merge swaps them and misses) and the step per
        (k, kk, L, W, rerank)."""
        from ..distributed.sharding import data_mesh
        from ..serving.steps import make_sharded_unified_step
        from .graph import LaneStack, shard_lti
        n = self._shard_count()
        if self._shard_group is None or len(self._shard_group) != n:
            self._shard_group = data_mesh(n, device=self.device)
            self._shard_place = None
            self._shard_steps = {}
        place = self._shard_place
        if (place is None or place[0] is not stack.lti
                or place[1] is not stack.codes):
            sg, sc = shard_lti(stack.lti, stack.codes, n,
                               devices=self._shard_group)
            place = (stack.lti, stack.codes, sg, sc)
            self._shard_place = place
        key = (k, kk, L, W, rerank)
        step = self._shard_steps.get(key)
        if step is None:
            step = make_sharded_unified_step(
                self._shard_group, self.cfg.index, k=k, k_lane=kk, L=L,
                beam_width=W, rerank=rerank)
            self._shard_steps[key] = step
        return step, LaneStack(stack.temps, place[2], place[3],
                               stack.codebook)

    # ------------------------------------------------------------ autotune
    def _beam_width(self, queries: np.ndarray) -> int:
        """W: autotuned (cached until the next merge or consolidation) or
        the configured one."""
        if not self.cfg.autotune_beam:
            return self.cfg.index.beam_width
        if self._tuned_w is None:
            tuned = self._calibrate_beam(queries)
            if tuned is None:          # no representative tier yet: keep
                return self.cfg.index.beam_width   # the static W, uncached
            self._tuned_w = tuned
        return self._tuned_w

    def _beam_sweep(self, queries: np.ndarray) -> Optional[list]:
        """The autotuner's sweep on this system: one ``BeamPoint`` per
        ``cfg.beam_width_candidates`` width, or None when no tier holds L
        points yet.  With ``batch_fanout`` the probe (the first 8 queries,
        k 1) runs the unified fan-out itself: per-query IO rounds are the
        max over lanes, distance computations the sum.  Without it, the
        LTI alone, else the RW tier."""
        L = self.cfg.index.L_search
        probe = torch.as_tensor(np.asarray(queries[:8], np.float32)).to(
            self.device)
        rw_t, ro_temps, lti_entry = self._capture_lanes()
        sizes = ([rw_t.n] if rw_t is not None else []) \
            + [t.n for t in ro_temps] \
            + ([int(lti_entry[0].graph.n_total)] if lti_entry else [])
        if not sizes or max(sizes) < L:
            return None
        if self.cfg.batch_fanout:
            key, stack, t_tabs, l_tab, tables_np = self._lane_bundle(
                rw_t, ro_temps, lti_entry)[:5]
            t_drop, l_drop = self._drop_mask(key, tables_np)

            def run(W):
                _, _, hops, cmps = mem.unified_search(
                    stack, t_tabs, l_tab, t_drop, l_drop, probe,
                    self.cfg.index, k=1, k_lane=1, L=L, beam_width=W,
                    rerank=self.cfg.rerank and lti_entry is not None)
                return host(hops).max(axis=0), host(cmps).sum(axis=0)
        else:
            lti = self._lti_pair[0]
            if int(lti.graph.n_total) >= L:
                def run(W):
                    _, _, hops, cmps = search_lti(lti, probe, self.cfg.index,
                                                  k=1, L=L, beam_width=W)
                    return host(hops), host(cmps)
            elif self.rw.n >= L:
                def run(W):
                    _, _, hops, cmps = mem.search(self.rw.state, probe,
                                                  self.temp_cfg, k=1, L=L,
                                                  beam_width=W)
                    return host(hops), host(cmps)
            else:
                return None
        return autotune.measure_widths(run, self.cfg.beam_width_candidates)

    def _calibrate_beam(self, queries: np.ndarray) -> Optional[int]:
        """The W of the cheapest point of ``_beam_sweep`` under the
        default cost model (None when there is no sweep yet)."""
        points = self._beam_sweep(queries)
        return None if points is None else autotune.pick_beam_width(points)

    def _capture_lanes(self):
        """Every searchable tier: (RW or None, live RO tiers, LTI entry),
        captured RW before RO before LTI: a concurrent rollover (RW -> RO)
        or merge (RO -> LTI) then lands its points in both captures (the
        dedupe resolves it), never in neither."""
        rw = self.rw
        rw_t = rw if rw.n > 0 else None
        with self._ro_lock:
            ro_temps = [t for t in self.ro if t.n > 0]
        lti, lti_table, lti_labels = self._lti_pair     # one generation
        lti_entry = ((lti, lti_table, lti_labels)
                     if int(lti.graph.n_total) > 0 else None)
        return rw_t, ro_temps, lti_entry

    @staticmethod
    def _fits_int32(a: np.ndarray) -> bool:
        return (a.max(initial=-1) <= np.iinfo(np.int32).max
                and a.min(initial=0) >= np.iinfo(np.int32).min)

    def _lane_bundle(self, rw_t, ro_temps, lti_entry):
        """(key, LaneStack, temp tables [Tt, cap], LTI table [lti_cap],
        host tables, label tables) for the fan-out, cached by tier-state
        identity.  External ids ride as int32 on the device when they fit,
        else int64.  The label tables are lane-ordered ([RW] + RO, LTI),
        aligned with the stacked lanes."""
        fp = ([rw_t] if rw_t is not None else []) + ro_temps
        key = tuple(t.state for t in fp) + (
            (lti_entry[0],) if lti_entry is not None else ())
        cached = self._fanout_cache
        if cached is not None and self._key_hits(cached[0], key):
            return cached[1]
        tcap = max((t.state.capacity for t in fp), default=0)
        temp_np = np.full((len(fp), tcap), -1, np.int64)
        for i, t in enumerate(fp):
            temp_np[i, :len(t.ext_ids)] = t.ext_ids
        lti_np = lti_entry[1] if lti_entry is not None else None
        fits = self._fits_int32(temp_np) and (
            lti_np is None or self._fits_int32(lti_np))
        id_dtype = torch.int32 if fits else torch.int64
        lti_graph = codes = codebook = None
        if lti_entry is not None:
            lti_graph = lti_entry[0].graph
            codes = lti_entry[0].codes
            codebook = lti_entry[0].codebook.centroids
        stack = stack_lanes([pad_graph(t.state, tcap) for t in fp],
                            lti=lti_graph, codes=codes, codebook=codebook)
        t_tabs = (torch.as_tensor(temp_np).to(self.device, id_dtype)
                  if fp else None)
        l_tab = (torch.as_tensor(lti_np).to(self.device, id_dtype)
                 if lti_np is not None else None)
        label_tabs = ([t.labels for t in fp],
                      lti_entry[2] if lti_entry is not None else None)
        bundle = (key, stack, t_tabs, l_tab, (temp_np, lti_np), label_tabs)
        self._fanout_cache = (key, bundle)
        return bundle

    @staticmethod
    def _key_hits(cached_key: tuple, key: tuple) -> bool:
        return (len(cached_key) == len(key)
                and all(a is b for a, b in zip(cached_key, key)))

    def _epoch_hits(self, cached, key: tuple) -> bool:
        """A (key, epoch, ...) mask cache entry is current."""
        return (cached is not None and cached[1] == self._delete_epoch
                and self._key_hits(cached[0], key))

    def _masks(self, bundle: tuple, fspec: Optional[FilterSpec]):
        """The drop masks of one dispatch: the DeleteList's, or with a
        spec the filtered ones."""
        key, tables_np = bundle[0], bundle[4]
        if fspec is None:
            return self._drop_mask(key, tables_np)
        return self._filter_drop(key, tables_np, bundle[5], fspec)

    def _delete_masks_np(self, tables_np: tuple):
        """Host DeleteList membership masks over the lane tables (temp
        [Tt, cap], LTI [cap] or None): the base of both drop masks."""
        temp_np, lti_np = tables_np
        deleted = self.deleted_ext.copy()
        dl = np.fromiter(deleted, np.int64, len(deleted))
        return (np.isin(temp_np, dl),
                np.isin(lti_np, dl) if lti_np is not None else None)

    def _to_device_masks(self, t_mask: np.ndarray, l_mask):
        return (torch.as_tensor(t_mask).to(self.device)
                if t_mask.shape[0] else None,
                torch.as_tensor(l_mask).to(self.device)
                if l_mask is not None else None)

    def _drop_mask(self, key: tuple, tables_np: tuple):
        """DeleteList membership masks over the lane tables, (temp
        [Tt, cap] or None, LTI [cap] or None), cached by (lanes, epoch)."""
        epoch = self._delete_epoch
        if self._epoch_hits(self._drop_cache, key):
            return self._drop_cache[2]
        drop = self._to_device_masks(*self._delete_masks_np(tables_np))
        self._drop_cache = (key, epoch, drop)
        return drop

    def _filter_drop(self, key: tuple, tables_np: tuple, label_tabs: tuple,
                     fspec: FilterSpec):
        """The filtered drop masks: the DeleteList's ORed with ``~match``
        of ``fspec`` against each lane's label table (lane padding matches
        nothing).  Cached per spec under (lanes, delete epoch): any tier or
        DeleteList change retires them all."""
        epoch = self._delete_epoch
        cached = self._filter_cache
        if self._epoch_hits(cached, key):
            specs = cached[2]
        else:
            specs = {}
            self._filter_cache = (key, epoch, specs)
        drop = specs.get(fspec)
        if drop is not None:
            return drop
        t_mask, l_mask = self._delete_masks_np(tables_np)
        temp_labels, lti_labels = label_tabs
        for i, lt in enumerate(temp_labels):
            m = filter_match(lt, fspec)
            t_mask[i, :m.size] |= ~m
            t_mask[i, m.size:] = True
        if l_mask is not None:
            l_mask |= ~filter_match(lti_labels, fspec)
        drop = self._to_device_masks(t_mask, l_mask)
        specs[fspec] = drop
        return drop

    # --------------------------------------------------------------- update
    def _new_temp(self) -> _Temp:
        return _Temp(empty_graph(self.temp_cfg, self.device),
                     np.full(self.cfg.temp_capacity, -1, np.int64),
                     LabelTable(self.cfg.temp_capacity, self._n_label_words))

    def _flush_inserts(self) -> None:
        """Land the insert buffer in the RW tier: the buffer swap under
        ``_insert_lock``, the compute and publish under ``_flush_lock``
        alone."""
        if not self._insert_buf_id:
            return
        with self._flush_lock:
            with self._insert_lock:
                ids, vecs = self._insert_buf_id, self._insert_buf_v
                bits, tens = self._insert_buf_bits, self._insert_buf_tenant
                if not ids:
                    return
                self._insert_buf_id, self._insert_buf_v = [], []
                self._insert_buf_bits, self._insert_buf_tenant = [], []
            t0 = time.perf_counter()
            self._flush_compute(ids, vecs, bits, tens)
            self.stats.flushes += 1
            self.stats.flush_latency.record(time.perf_counter() - t0)

    def _flush_compute(self, ids: list, vecs: list, bits: list,
                       tens: list) -> None:
        """Insert one drained buffer into the RW tier, ``insert_batch``
        points per ``insert_edges_stage`` + ``insert_apply_delta``: in
        arrival order, or with ``locality_order`` the whole buffer
        proximity-ordered first (seeded per flush; the order is computed on
        the CPU, so the CPU and the card take the same one).  Ext-id and
        label rows are written before the new state is published."""
        B = self.cfg.insert_batch
        dev = self.device
        if self.cfg.locality_order and len(ids) > 1:
            perm = locality_order(
                torch.from_numpy(np.stack(vecs)),
                n_clusters=self.cfg.index.locality_clusters or 16,
                seed=self._flush_seq).tolist()
            ids = [ids[i] for i in perm]
            vecs = [vecs[i] for i in perm]
            bits = [bits[i] for i in perm]
            tens = [tens[i] for i in perm]
        self._flush_seq += 1
        t = self.rw
        for lo in range(0, len(ids), B):
            chunk_i = ids[lo:lo + B]
            chunk_v = vecs[lo:lo + B]
            chunk_b = bits[lo:lo + B]
            chunk_t = tens[lo:lo + B]
            slots = np.arange(t.n, t.n + len(chunk_i), dtype=np.int32)
            if t.n == 0:
                # Seed the empty temp graph: the first point is the start.
                st = t.state
                st.vectors[0] = torch.as_tensor(chunk_v[0]).to(
                    dev, st.vectors.dtype)
                st.active[0] = True
                t.ext_ids[0] = chunk_i[0]
                t.labels.set_row(0, chunk_b[0], chunk_t[0])
                t.state = st._replace(
                    start=torch.zeros((), dtype=torch.int32, device=dev),
                    n_total=torch.ones((), dtype=torch.int32, device=dev))
                self._ext_loc[chunk_i[0]] = ("rw", 0)
                chunk_i, chunk_v, slots = chunk_i[1:], chunk_v[1:], slots[1:]
                chunk_b, chunk_t = chunk_b[1:], chunk_t[1:]
                t.n = 1
                if not chunk_i:
                    continue
            pad = B - len(chunk_i)
            pslots = np.concatenate([slots, np.full(pad, INVALID, np.int32)])
            pvecs = np.zeros((B, self.cfg.index.dim), np.float32)
            pvecs[:len(chunk_v)] = np.stack(chunk_v)
            st, pj, pp = mem.insert_edges_stage(
                t.state, torch.as_tensor(pslots).to(dev),
                torch.as_tensor(pvecs).to(dev), self.temp_cfg)
            pj_h = pj.cpu().numpy()
            self.stats.flush_backedge_targets += int(
                np.unique(pj_h[pj_h >= 0]).size)
            st = mem.insert_apply_delta(st, pj, pp, self.temp_cfg)
            t.ext_ids[slots] = chunk_i
            t.labels.bits[slots] = np.stack(chunk_b)
            t.labels.tenant[slots] = chunk_t
            t.state = st
            for s, e in zip(slots, chunk_i):
                self._ext_loc[e] = ("rw", int(s))
            t.n += len(chunk_i)

    def _maybe_rollover(self) -> None:
        """Freeze the RW tier into an RO snapshot at
        ``ro_snapshot_points``; at ``merge_threshold`` staged points (not
        counting those an in-flight merge is consuming) start a
        StreamingMerge, on the worker thread with ``background_merge``."""
        with self._flush_lock, self._insert_lock:
            if self.rw.n >= self.cfg.ro_snapshot_points:
                self._flush_inserts()
                frozen = self.rw
                with self._ro_lock:
                    self.ro.append(frozen)
                self.rw = self._new_temp()
                for slot in np.nonzero(frozen.ext_ids >= 0)[0]:
                    e = int(frozen.ext_ids[slot])
                    if self._ext_loc.get(e) == ("rw", int(slot)):
                        self._ext_loc[e] = ("ro", int(slot))
                self.stats.snapshots += 1
            with self._ro_lock:
                staged = sum(t.n for t in self.ro) - self._merge_inflight
        # Outside the insert lock: a foreground merge holding it would
        # deadlock against a background merge's DeleteList update.
        if staged >= self.cfg.merge_threshold:
            self.merge(background=self.cfg.background_merge)

    # --------------------------------------------------------- storage tier
    def _storage_path(self) -> str:
        return os.path.join(self.cfg.storage_dir, "lti")

    def _sync_storage(self, adj_changed: Optional[np.ndarray] = None) -> None:
        """Mirror the live (LTI, ext ids, labels) to the layout at
        ``cfg.storage_dir``: a full write the first time, a delta patch
        afterwards (``adj_changed``: the rows a merge or consolidation
        rewrote).  An open disk searcher is closed first: its side tables
        would go stale."""
        self.close_storage()
        path = self._storage_path()
        os.makedirs(self.cfg.storage_dir, exist_ok=True)
        lti, table, labels = self._lti_pair
        if is_layout(path):
            ps = patch_layout(path, lti.graph, codes=lti.codes,
                              ext_ids=table, adj_changed=adj_changed,
                              label_bits=labels.bits,
                              label_tenant=labels.tenant)
            self.stats.storage_rows_patched += ps.adj_rows
            self.stats.storage_blocks_patched += ps.adj_blocks
            self.stats.storage_bytes_written += ps.bytes_written
        else:
            lay = write_layout(path, lti.graph, codes=lti.codes,
                               codebook=lti.codebook, ext_ids=table,
                               label_bits=labels.bits,
                               label_tenant=labels.tenant)
            self.stats.storage_bytes_written += (
                lay.capacity * (lay.row_bytes + lay.dim * 4 + lay.m))
            lay.close()

    def _disk_searcher_get(self) -> DiskLTISearcher:
        """The cached searcher over the live layout (reopened after every
        sync, so it serves the current generation)."""
        if self._disk_searcher is None:
            self._disk_searcher = DiskLTISearcher(
                open_layout(self._storage_path()), self.cfg.index,
                cache_mb=self.cfg.adjacency_cache_mb,
                prefetch_depth=self.cfg.prefetch_depth,
                latency_us=self.cfg.io_latency_us, device=self.device)
        return self._disk_searcher

    def close_storage(self) -> None:
        """Stop the prefetch thread and drop the layout's mmaps (no-op when
        no disk searcher is open)."""
        if self._disk_searcher is not None:
            s, self._disk_searcher = self._disk_searcher, None
            s.close()
            s.layout.close()

    def search_disk(self, queries: np.ndarray, k: int,
                    L: Optional[int] = None,
                    beam_width: Optional[int] = None,
                    filter: Optional[FilterSpec] = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """The §5.2 fan-out with the LTI lane served off the layout: PQ
        navigation on in-memory codes, adjacency rows from ``topology.bin``
        through the block cache and the prefetch pipeline
        (``cfg.adjacency_cache_mb``, ``cfg.prefetch_depth``), the exact
        rerank from ``data.bin``; the temp tiers, memory-resident, go
        through ``index.search`` one by one.  Returns (ext_ids [B, k],
        dists [B, k]) equal to ``search_batch``'s; the reader's IO deltas
        are folded into ``stats.io_*``.  ``filter`` as in
        ``search_batch``; the LTI lane is filtered against the layout's own
        label tables (the generation it searched)."""
        if not self.cfg.storage_dir:
            raise ValueError("search_disk needs SystemConfig.storage_dir")
        self._flush_inserts()
        fspec = self._resolve_filter(filter)
        L = L or self.cfg.index.L_search
        if k > L:
            raise ValueError(f"search(k={k}, L={L}): k must be <= L")
        W = beam_width or self.cfg.index.beam_width
        kk = min(max(k * 2, k + 8), L)
        q = np.asarray(queries, np.float32)
        B = q.shape[0]
        self._count_searches(B, fspec)
        if B == 0:
            return (np.zeros((0, k), np.int64), np.zeros((0, k), np.float32))
        rw_t, ro_temps, lti_entry = self._capture_lanes()
        cands: list[tuple[np.ndarray, np.ndarray]] = []
        if lti_entry is not None:
            s = self._disk_searcher_get()
            before = s.stats.snapshot()
            ids, d, _, _, _ = s.search(q, k=kk, L=L, beam_width=W,
                                       rerank=self.cfg.rerank)
            ids, d = host(ids), host(d)
            self.stats.search_dispatches += 1
            after = s.stats.snapshot()

            def delta(key):
                return after[key] - before[key]

            self.stats.io_rows_read += (delta("demand_reads")
                                        + delta("prefetch_hits"))
            self.stats.io_cache_hits += delta("cache_hits")
            self.stats.io_prefetch_hits += delta("prefetch_hits")
            self.stats.io_bytes_read += delta("bytes_read")
            lay = s.layout
            lay_labels = None
            if lay.label_tenant is not None:
                lay_labels = LabelTable(
                    lay.capacity, 0 if lay.label_bits is None
                    else lay.label_bits.shape[1], lay.label_bits,
                    lay.label_tenant)
            cands.append((self._map_ext(ids, lay.ext_ids),
                          self._slot_filter(ids, d, lay_labels, fspec)))
        qd = torch.from_numpy(q).to(self.device)
        for t in ([rw_t] if rw_t is not None else []) + ro_temps:
            ids, d, _, _ = mem.search(t.state, qd, self.temp_cfg, k=kk, L=L,
                                      beam_width=W)
            self.stats.search_dispatches += 1
            ids = host(ids)
            cands.append((self._map_ext(ids, t.ext_ids),
                          self._slot_filter(ids, host(d), t.labels, fspec)))
        return self._aggregate(cands, k, B)

    @staticmethod
    def _map_ext(slot_ids: np.ndarray, table: np.ndarray) -> np.ndarray:
        out = np.full(slot_ids.shape, -1, np.int64)
        ok = slot_ids >= 0
        out[ok] = table[slot_ids[ok]]
        return out

    def _aggregate(self, cands, k, nq):
        """Host fan-in of per-tier candidates: DeleteList drop, cross-tier
        dedupe keeping the closest copy (lexsort by (id, dist)), global
        top-k, (-1, +inf) padding."""
        if not cands:
            return (np.full((nq, k), -1, np.int64),
                    np.full((nq, k), np.inf, np.float32))
        ids = np.concatenate([c[0] for c in cands], axis=1)
        ds = np.concatenate([c[1] for c in cands], axis=1).astype(np.float32)
        deleted = self.deleted_ext.copy()
        bad = ids < 0
        if deleted:
            dl = np.fromiter(deleted, np.int64, len(deleted))
            bad |= np.isin(ids, dl)
        ds[bad] = np.inf
        order = np.lexsort((ds, ids), axis=1)
        sid = np.take_along_axis(ids, order, axis=1)
        sd = np.take_along_axis(ds, order, axis=1)
        dup = np.zeros_like(sid, bool)
        dup[:, 1:] = (sid[:, 1:] == sid[:, :-1]) & (sid[:, 1:] >= 0)
        sd[dup] = np.inf
        top = np.argsort(sd, axis=1, kind="stable")[:, :k]
        res_d = np.take_along_axis(sd, top, axis=1)
        res_i = np.where(np.isfinite(res_d),
                         np.take_along_axis(sid, top, axis=1), -1)
        if res_i.shape[1] < k:
            pad = k - res_i.shape[1]
            res_i = np.pad(res_i, ((0, 0), (0, pad)), constant_values=-1)
            res_d = np.pad(res_d, ((0, 0), (0, pad)),
                           constant_values=np.inf)
        return res_i.astype(np.int64), res_d.astype(np.float32)

    # ------------------------------------------------------------ snapshots
    def save(self, path: str) -> None:
        """Snapshot the system into the directory ``path`` (the reference's
        files: ``layout/`` with ``storage_dir`` else ``lti.npz``, and
        ``temps.pkl``, ``meta.pkl``)."""
        with self._flush_lock, self._insert_lock:
            self._save_locked(path)

    def _save_locked(self, path: str) -> None:
        # Caller holds _flush_lock + _insert_lock (RLocks; the flush nests).
        self._flush_inserts()
        os.makedirs(path, exist_ok=True)
        lti, table, labels = self._lti_pair
        if self.cfg.storage_dir:
            write_layout(os.path.join(path, "layout"), lti.graph,
                         codes=lti.codes, codebook=lti.codebook,
                         ext_ids=table, generation=self.stats.merges,
                         label_bits=labels.bits,
                         label_tenant=labels.tenant).close()
        else:
            np.savez_compressed(
                os.path.join(path, "lti.npz"),
                **{f"g_{k}": host(v) for k, v in lti.graph._asdict().items()},
                codes=host(lti.codes), centroids=host(lti.codebook.centroids),
                ext_ids=table, label_bits=labels.bits,
                label_tenant=labels.tenant)
        # Only builtins and numpy: a temp is (graph fields in GraphState
        # order, ext ids, n, label bits, tenants), as the reference reads.
        temps = [(tuple(host(x) for x in t.state), t.ext_ids, t.n,
                  t.labels.bits, t.labels.tenant) for t in self.ro + [self.rw]]
        with open(os.path.join(path, "temps.pkl"), "wb") as f:
            pickle.dump(temps, f)
        # How much of the WAL (and which epoch) the snapshot covers, so
        # recovery replays only the suffix.
        wal_offset = wal_epoch = None
        if self.wal and os.path.exists(self.wal.path):
            wal_offset = os.path.getsize(self.wal.path)
            wal_epoch = log_epoch(self.wal.path)
        with open(os.path.join(path, "meta.pkl"), "wb") as f:
            pickle.dump({"deleted": set(self.deleted_ext),
                         "cfg": dataclasses.asdict(self.cfg),
                         "wal_offset": wal_offset, "wal_epoch": wal_epoch}, f)

    @classmethod
    def load(cls, path: str, cfg: SystemConfig,
             device="cuda") -> "FreshDiskANN":
        """A system from a snapshot written by either package (its WAL and
        layout opened under ``cfg``).  Label tables are read where the
        snapshot has them (label-free snapshots and the historical 3-tuple
        temps have none: no labels, no tenants)."""
        dev = resolve_device(device)
        lay_path = os.path.join(path, "layout")
        bits = tenant = None
        if is_layout(lay_path):
            lay = open_layout(lay_path)
            lti = lay.lti_state(dev)
            ext_ids = lay.ext_ids.copy()
            bits, tenant = lay.label_bits, lay.label_tenant
            lay.close()
        else:
            with np.load(os.path.join(path, "lti.npz")) as z:
                g = GraphState(*(torch.from_numpy(z[f"g_{k}"]).to(dev)
                                 for k in GraphState._fields))
                lti = LTIState(g, torch.from_numpy(z["codes"]).to(dev),
                               pqm.PQCodebook(torch.from_numpy(
                                   z["centroids"]).to(dev)))
                ext_ids = z["ext_ids"].copy()
                if "label_tenant" in z.files:
                    bits, tenant = z["label_bits"], z["label_tenant"]
        sys_ = cls(cfg, lti=lti, lti_ext_ids=ext_ids, device=dev,
                   lti_labels=_label_table(len(ext_ids), cfg.filter_words,
                                           bits, tenant))
        with open(os.path.join(path, "temps.pkl"), "rb") as f:
            temps = _SnapshotUnpickler(f).load()
        for i, entry in enumerate(temps):
            s, e, n = entry[:3]
            bits, tenant = entry[3:5] if len(entry) >= 5 else (None, None)
            t = _Temp(GraphState(*(torch.from_numpy(np.array(x)).to(dev)
                                   for x in s)),
                      np.array(e, np.int64),
                      _label_table(len(e), cfg.filter_words, bits, tenant),
                      int(n))
            # The last entry is the RW tier, the others RO snapshots.
            is_rw = i == len(temps) - 1
            if is_rw:
                sys_.rw = t
            else:
                sys_.ro.append(t)
            tag = "rw" if is_rw else "ro"
            for slot in np.nonzero(t.ext_ids >= 0)[0]:
                sys_._ext_loc[int(t.ext_ids[slot])] = (tag, int(slot))
        with open(os.path.join(path, "meta.pkl"), "rb") as f:
            meta = _SnapshotUnpickler(f).load()
        sys_.deleted_ext = {int(e) for e in meta["deleted"]}
        sys_._wal_offset = meta.get("wal_offset")
        sys_._wal_epoch = meta.get("wal_epoch")
        return sys_

    def latest_snapshot(self) -> Optional[str]:
        """The most recent merge snapshot under ``cfg.snapshot_dir``."""
        d = self.cfg.snapshot_dir
        if not d or not os.path.isdir(d):
            return None
        snaps = [s for s in os.listdir(d) if s.startswith("merge_")]
        if not snaps:
            return None
        return os.path.join(d, max(snaps, key=lambda s: int(s.split("_")[1])))

    def recover(self, snapshot_path: Optional[str] = None) -> int:
        """Crash recovery (§5.6): restore ``snapshot_path`` (default: the
        newest merge snapshot under ``cfg.snapshot_dir``), then replay the
        WAL suffix it does not cover.  Returns the records replayed."""
        start = epoch = None
        if snapshot_path is None:
            snapshot_path = self.latest_snapshot()
        if snapshot_path:
            restored = FreshDiskANN.load(snapshot_path, self.cfg,
                                         device=self.device)
            if restored.wal:              # keep only our own WAL handle
                restored.wal.close()
            self._lti_pair = restored._lti_pair
            self.rw = restored.rw
            self.ro = restored.ro
            self.deleted_ext = restored.deleted_ext
            self._ext_loc = restored._ext_loc
            self._insert_buf_v, self._insert_buf_id = [], []
            self._insert_buf_bits, self._insert_buf_tenant = [], []
            self._fanout_cache = self._drop_cache = None
            self._filter_cache = None
            self._delete_epoch += 1
            # The restored system re-synced the live layout; a searcher
            # still open over the old generation must reopen.
            self.close_storage()
            start, epoch = restored._wal_offset, restored._wal_epoch
        n = 0
        wal_path = self.wal.path if self.wal else None
        if wal_path and os.path.exists(wal_path):
            # A snapshot of an older epoch (the log was truncated since),
            # or an offset past the end: replay the whole log.
            if start is not None and (start > os.path.getsize(wal_path)
                                      or epoch != log_epoch(wal_path)):
                start = None
            records = list(replay(wal_path, start))
            # Replay without logging again: the records are in the log.
            wal, self.wal = self.wal, None
            try:
                for op, ext_id, vec in records:
                    if op == OP_INSERT:
                        self.insert(ext_id, vec)
                    elif op == OP_DELETE:
                        self.delete(ext_id)
                    elif op == OP_INSERT_LABELED:   # (vec, tenant, bits)
                        self.insert(ext_id, vec.vec,
                                    labels=unpack_labels(vec.bits),
                                    tenant=(None if vec.tenant == NO_TENANT
                                            else vec.tenant))
                    n += 1
                self._flush_inserts()
            finally:
                self.wal = wal
        return n

    # -------------------------------------------------------------- helpers
    @property
    def size(self) -> int:
        """Number of distinct live external ids."""
        uniq = self._live_ext_ids()
        if not self.deleted_ext:
            return len(uniq)
        dl = np.fromiter(self.deleted_ext, np.int64, len(self.deleted_ext))
        return int(len(uniq) - np.isin(uniq, dl).sum())

    def _live_ext_ids(self) -> np.ndarray:
        """Sorted unique external ids with a copy in any tier or the insert
        buffer (before DeleteList filtering)."""
        parts = [self.lti_ext_ids] + [t.ext_ids for t in [self.rw] + self.ro]
        if self._insert_buf_id:
            parts.append(np.asarray(self._insert_buf_id, np.int64))
        arr = np.concatenate(parts)
        return np.unique(arr[arr >= 0])


def bootstrap_system(vectors: np.ndarray, ext_ids: np.ndarray,
                     cfg: SystemConfig, labels=None, tenants=None,
                     device="cuda", **build_kw) -> FreshDiskANN:
    """Build the initial static LTI (paper: start from a DiskANN build) and
    the system around it.  ``build_kw`` goes to ``lti.build_lti`` (e.g. a
    ready-made ``codebook``).  ``labels`` (per point, an iterable of label
    bit indices) and ``tenants`` (per point, a tenant id) tag the points:
    the build fills slots in input order, so row i's land in slot i."""
    lti = build_lti(vectors, cfg.index, cfg.pq, device=device, **build_kw)
    table = np.full(cfg.index.capacity, -1, np.int64)
    table[:len(ext_ids)] = ext_ids
    lb = LabelTable(cfg.index.capacity, cfg.filter_words)
    if labels is not None:
        for i, ls in enumerate(labels):
            lb.bits[i] = pack_labels(ls, lb.n_words)
    if tenants is not None:
        lb.tenant[:len(tenants)] = np.asarray(tenants, np.int32)
    return FreshDiskANN(cfg, lti=lti, lti_ext_ids=table, device=device,
                        lti_labels=lb)


def _label_table(capacity: int, n_words: int, bits, tenant) -> LabelTable:
    """A tier's ``LabelTable`` from stored side tables (None: no labels):
    tenants as stored, the first ``min(stored, n_words)`` words of bits."""
    lb = LabelTable(capacity, n_words)
    if tenant is not None:
        lb.tenant[:] = tenant
        if bits is not None and np.asarray(bits).size:
            w = min(n_words, np.asarray(bits).shape[1])
            lb.bits[:, :w] = np.asarray(bits)[:, :w]
    return lb


class _FieldTuple(tuple):
    """A pickled ``repro.core.graph`` NamedTuple (``GraphState``), read as
    the plain tuple of its fields."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class _FieldDict(dict):
    """A pickled ``repro.core.config`` dataclass, read as a dict of its
    fields."""

    def __setstate__(self, state):
        self.update(state)


class _SnapshotUnpickler(pickle.Unpickler):
    """Reads snapshot pickles of either package without importing the
    reference: its ``GraphState`` and config classes become plain
    containers, and any other class of ``repro`` is refused."""

    def find_class(self, module, name):
        if module == "repro.core.graph":
            return _FieldTuple
        if module == "repro.core.config":
            return _FieldDict
        if module == "repro" or module.startswith("repro."):
            raise pickle.UnpicklingError(
                f"snapshot pickle names {module}.{name}, which repro_torch "
                "does not read")
        return super().find_class(module, name)
