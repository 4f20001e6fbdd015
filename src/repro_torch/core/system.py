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

A merge builds a NEW LTI (``merge.streaming_merge`` writes only copies)
while searches read the old one; the (LTI, external-id table) pair is
swapped as one tuple once the merge's device work has finished, and the RO
snapshots it consumed leave ``self.ro`` only after that swap, so a search
racing a merge sees every point in one whole generation (or briefly in two,
which the cross-tier dedupe resolves).  The reference's locks keep their
canonical order: ``_flush_lock`` -> ``_insert_lock`` -> ``_ro_lock``, and
``_merge_lock`` around merges and consolidations.

Not ported yet, and raising ``NotImplementedError`` naming the slice that
ports it: the WAL and snapshots (``wal_dir``, ``snapshot_dir``), the disk
layout (``storage_dir``), the sharded LTI lane (``shard_lti``), filters and
tenants (``filter_words``, ``labels``, ``tenant``), the beam-width
autotuner (``autotune_beam``) and the sequential per-tier query path
(``batch_fanout=False``).

External ids are user-provided int64s; the system maps them to
(tier, slot).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import index as mem
from . import pq as pqm
from .config import SystemConfig, resolve_device
from .delete import affected_mask, consolidate_deletes
from .distance import INVALID
from .graph import GraphState, empty_graph, pad_graph, stack_lanes
from .locality import locality_order
from .lti import LTIState, build_lti
from .merge import streaming_merge
from .reach import unreachable_fraction

_UNPORTED = (
    ("wal_dir", None, "the WAL and snapshot slice"),
    ("snapshot_dir", None, "the WAL and snapshot slice"),
    ("storage_dir", None, "the storage slice"),
    ("shard_lti", 0, "the serving and sharding slice"),
    ("filter_words", 0, "the filters slice"),
    ("autotune_beam", False, "the autotune slice"),
    ("batch_fanout", True,
     "the serving and sharding slice, with the "
     "sequential per-tier query path"),
)


def check_ported(cfg: SystemConfig) -> None:
    """Raise ``NotImplementedError`` for a knob the port does not run yet."""
    for name, default, where in _UNPORTED:
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"SystemConfig.{name}={getattr(cfg, name)!r} is not ported "
                f"to repro_torch yet; it comes with {where}")


@dataclass
class _Temp:
    """One TempIndex instance + its slot -> external-id map."""
    state: GraphState
    ext_ids: np.ndarray           # [capacity] int64, -1 free
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
    #   merges, the device synchronized at each phase boundary
    insert_latency: Reservoir = field(default_factory=Reservoir, repr=False)
    search_latency: Reservoir = field(
        default_factory=lambda: Reservoir(seed=1), repr=False)
    flush_latency: Reservoir = field(
        default_factory=lambda: Reservoir(seed=3), repr=False)

    def record_latency(self, seconds: float) -> None:
        self.insert_latency.record(seconds)


class FreshDiskANN:
    def __init__(self, cfg: SystemConfig, lti: Optional[LTIState] = None,
                 lti_ext_ids: Optional[np.ndarray] = None, device="cuda"):
        check_ported(cfg)
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
        self._lti_pair: tuple[LTIState, np.ndarray] = (
            lti, lti_ext_ids if lti_ext_ids is not None
            else np.full(icfg.capacity, -1, np.int64))
        self.rw = self._new_temp()
        self.ro: list[_Temp] = []
        self.deleted_ext: set[int] = set()
        self._ext_loc: dict[int, tuple] = {}
        if lti_ext_ids is not None:
            for slot in np.nonzero(lti_ext_ids >= 0)[0]:
                self._ext_loc[int(lti_ext_ids[slot])] = ("lti", int(slot))
        self._insert_buf_v: list[np.ndarray] = []
        self._insert_buf_id: list[int] = []
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
        # Fan-out caches keyed by tier-state identity (a flush, rollover or
        # merge replaces the state object) and, for the drop mask, the
        # DeleteList epoch (bumped on every DeleteList change).
        self._fanout_cache: Optional[tuple] = None
        self._drop_cache: Optional[tuple] = None
        self._delete_epoch = 0

    @property
    def lti(self) -> LTIState:
        return self._lti_pair[0]

    @property
    def lti_ext_ids(self) -> np.ndarray:
        return self._lti_pair[1]

    # ------------------------------------------------------------------ API
    def insert(self, ext_id: int, vec: np.ndarray, labels=None,
               tenant: Optional[int] = None) -> None:
        """Route to the RW TempIndex (paper §5.2); batched flush."""
        if labels or tenant is not None:
            raise NotImplementedError(
                "labelled and tenant inserts are not ported to repro_torch "
                "yet; they come with the filters slice")
        t0 = time.perf_counter()
        with self._insert_lock:
            self._insert_buf_id.append(int(ext_id))
            self._insert_buf_v.append(np.asarray(vec, np.float32))
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
            if e in self._insert_buf_id:
                # Only buffered: drop it there, or the next flush would
                # revive it and invert the op order.
                keep = [i for i, x in enumerate(self._insert_buf_id)
                        if x != e]
                self._insert_buf_id = [self._insert_buf_id[i] for i in keep]
                self._insert_buf_v = [self._insert_buf_v[i] for i in keep]
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
                     beam_width: Optional[int] = None, filter=None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Serve a query batch over the LTI and every TempIndex, drop the
        DeleteList, merge (§5.2).  Returns (ext_ids [B, k] int64,
        dists [B, k] f32).  ``cfg.batch_queries`` = N > 0 serves the batch
        in fixed chunks of N queries (the tail zero-padded and sliced off);
        ``stats.search_dispatches`` counts the chunks."""
        if filter is not None:
            raise NotImplementedError(
                "filtered search is not ported to repro_torch yet; it comes "
                "with the filters slice")
        self._flush_inserts()
        L = L or self.cfg.index.L_search
        if k > L:
            raise ValueError(
                f"search(k={k}, L={L}): k must be <= L -- the candidate list "
                f"holds only L entries; raise L or lower k")
        W = beam_width or self.cfg.index.beam_width
        kk = min(max(k * 2, k + 8), L)    # over-fetch for drops and dedupe
        q = np.asarray(queries, np.float32)
        B = q.shape[0]
        self.stats.searches += B
        if B == 0:
            return (np.zeros((0, k), np.int64), np.zeros((0, k), np.float32))
        bq = self.cfg.batch_queries
        if not bq or B == bq:
            return self._search_dispatch(q, k, kk, L, W)
        outs = []
        for lo in range(0, B, bq):
            chunk = q[lo:lo + bq]
            n = len(chunk)
            if n < bq:
                qp = np.zeros((bq, q.shape[1]), np.float32)
                qp[:n] = chunk
                chunk = qp
            ids, d = self._search_dispatch(chunk, k, kk, L, W)
            outs.append((ids[:n], d[:n]))
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))

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
        del_snapshot = set(self.deleted_ext)
        dl = np.fromiter(del_snapshot, np.int64, len(del_snapshot))
        # Stage the RO points in tier and slot order, minus re-deleted ones.
        parts_v, parts_e = [], []
        for t in ro:
            sl = np.nonzero(t.ext_ids >= 0)[0][:t.n]
            ext = t.ext_ids[sl]
            keep = ~np.isin(ext, dl)
            parts_v.append(t.state.vectors[torch.as_tensor(
                sl[keep]).to(self.device)])
            parts_e.append(ext[keep])
        w = sum(len(e) for e in parts_e)
        nn = max(staged, 1)
        vecs = torch.zeros((nn, icfg.dim), device=self.device)
        exts = np.full(nn, -1, np.int64)
        if w:
            vecs[:w] = torch.cat(parts_v).float()
            exts[:w] = np.concatenate(parts_e)
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
        # The ext-id table: deleted rows out, merged rows in at the slots
        # the merge assigned.
        new_ids = self._retire_lti_rows(dmask)
        slots = stats.slots.cpu().numpy()
        ok = valid & (slots >= 0)
        new_ids[slots[ok]] = exts[ok]
        for s_, e in zip(slots[ok], exts[ok]):
            self._ext_loc[int(e)] = ("lti", int(s_))
        # One generation swap, then retire exactly the RO snapshots merged.
        self._lti_pair = (new_lti, new_ids)
        with self._ro_lock:
            self.ro = self.ro[len(ro):]
            self._merge_inflight = 0
        self._retire_deletes(del_snapshot)
        self.stats.merges += 1
        self.stats.merge_seconds += time.perf_counter() - t0
        self._probe_reachability(repair_mode)

    def _retire_lti_rows(self, dmask: np.ndarray) -> np.ndarray:
        """A copy of the LTI ext-id table with the ``dmask`` rows cleared
        (and their ids' LTI locations forgotten)."""
        new_ids = self.lti_ext_ids.copy()
        for e in new_ids[dmask]:
            e = int(e)
            if e >= 0 and self._ext_loc.get(e, ("?",))[0] == "lti":
                del self._ext_loc[e]
        new_ids[dmask] = -1
        return new_ids

    def _retire_deletes(self, del_snapshot: set) -> None:
        """After a generation swap: a delete leaves the DeleteList only when
        no copy of its id survives anywhere (a copy in the RW tier, a newer
        RO tier or the insert buffer keeps it pending).  Drops the fan-out
        caches."""
        self._fanout_cache = None
        self._drop_cache = None
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
            lti, table = self._lti_pair
            del_snapshot = set(self.deleted_ext)
            dl = np.fromiter(del_snapshot, np.int64, len(del_snapshot))
            dmask = np.isin(table, dl) & lti.graph.active.cpu().numpy()
            n_del = int(dmask.sum())
            if n_del == 0:
                return 0
            g = lti.graph
            g = g._replace(deleted=g.deleted | torch.as_tensor(dmask).to(
                self.device))
            decoded = pqm.decode(lti.codebook, lti.codes, self.cfg.pq)
            new_g = consolidate_deletes(g, icfg, block=self.cfg.merge_block,
                                        prune_table=decoded, mode=mode)
            self._sync_device()
            if mode == "local":
                self.stats.local_repairs += 1
            else:
                self.stats.global_repairs += 1
                self._force_global_repair = False
            new_ids = self._retire_lti_rows(dmask)
            self._lti_pair = (LTIState(new_g, lti.codes, lti.codebook),
                              new_ids)
            self._retire_deletes(del_snapshot)
            self.stats.consolidations += 1
            self._probe_reachability(mode)
            return n_del

    # ---------------------------------------------------------------- query
    def _search_dispatch(self, queries, k, kk, L, W):
        """Timed wrapper: each dispatched micro-batch samples its wall time
        (to the results on the host) into ``stats.search_latency``."""
        d0 = self.stats.search_dispatches
        t0 = time.perf_counter()
        out = self._search_dispatch_impl(queries, k, kk, L, W)
        if self.stats.search_dispatches > d0:
            self.stats.search_latency.record(time.perf_counter() - t0)
        return out

    def _search_dispatch_impl(self, queries, k, kk, L, W):
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        nq = queries.shape[0]
        rw_t, ro_temps, lti_entry = self._capture_lanes()
        if rw_t is None and not ro_temps and lti_entry is None:
            return (np.full((nq, k), -1, np.int64),
                    np.full((nq, k), np.inf, np.float32))
        key, stack, t_tabs, l_tab, tables_np = self._lane_bundle(
            rw_t, ro_temps, lti_entry)
        t_drop, l_drop = self._drop_mask(key, tables_np)
        ids, d, _, _ = mem.unified_search(
            stack, t_tabs, l_tab, t_drop, l_drop, q, self.cfg.index, k=k,
            k_lane=kk, L=L, beam_width=W,
            rerank=self.cfg.rerank and lti_entry is not None)
        self.stats.search_dispatches += 1
        return (ids.cpu().numpy().astype(np.int64),
                d.cpu().numpy().astype(np.float32))

    def _capture_lanes(self):
        """Every searchable tier: (RW or None, live RO tiers, LTI entry),
        captured RW before RO before LTI: a concurrent rollover (RW -> RO)
        or merge (RO -> LTI) then lands its points in both captures (the
        dedupe resolves it), never in neither."""
        rw = self.rw
        rw_t = rw if rw.n > 0 else None
        with self._ro_lock:
            ro_temps = [t for t in self.ro if t.n > 0]
        lti, lti_table = self._lti_pair
        lti_entry = ((lti, lti_table) if int(lti.graph.n_total) > 0
                     else None)
        return rw_t, ro_temps, lti_entry

    @staticmethod
    def _fits_int32(a: np.ndarray) -> bool:
        return (a.max(initial=-1) <= np.iinfo(np.int32).max
                and a.min(initial=0) >= np.iinfo(np.int32).min)

    def _lane_bundle(self, rw_t, ro_temps, lti_entry):
        """(key, LaneStack, temp tables [Tt, cap], LTI table [lti_cap],
        host tables) for the fan-out, cached by tier-state identity.
        External ids ride as int32 on the device when they fit, else int64.
        """
        fp = ([rw_t] if rw_t is not None else []) + ro_temps
        key = tuple(t.state for t in fp) + (
            (lti_entry[0],) if lti_entry is not None else ())
        cached = self._fanout_cache
        if (cached is not None and len(cached[0]) == len(key)
                and all(a is b for a, b in zip(cached[0], key))):
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
        bundle = (key, stack, t_tabs, l_tab, (temp_np, lti_np))
        self._fanout_cache = (key, bundle)
        return bundle

    def _drop_mask(self, key: tuple, tables_np: tuple):
        """DeleteList membership masks over the lane tables, (temp
        [Tt, cap] or None, LTI [cap] or None), cached by (lanes, epoch)."""
        cached = self._drop_cache
        if (cached is not None and cached[1] == self._delete_epoch
                and len(cached[0]) == len(key)
                and all(a is b for a, b in zip(cached[0], key))):
            return cached[2]
        temp_np, lti_np = tables_np
        dl = np.fromiter(self.deleted_ext, np.int64, len(self.deleted_ext))
        t_mask = np.isin(temp_np, dl)
        drop = (torch.as_tensor(t_mask).to(self.device)
                if t_mask.shape[0] else None,
                torch.as_tensor(np.isin(lti_np, dl)).to(self.device)
                if lti_np is not None else None)
        self._drop_cache = (key, self._delete_epoch, drop)
        return drop

    # --------------------------------------------------------------- update
    def _new_temp(self) -> _Temp:
        return _Temp(empty_graph(self.temp_cfg, self.device),
                     np.full(self.cfg.temp_capacity, -1, np.int64))

    def _flush_inserts(self) -> None:
        """Land the insert buffer in the RW tier: the buffer swap under
        ``_insert_lock``, the compute and publish under ``_flush_lock``
        alone."""
        if not self._insert_buf_id:
            return
        with self._flush_lock:
            with self._insert_lock:
                ids, vecs = self._insert_buf_id, self._insert_buf_v
                if not ids:
                    return
                self._insert_buf_id, self._insert_buf_v = [], []
            t0 = time.perf_counter()
            self._flush_compute(ids, vecs)
            self.stats.flushes += 1
            self.stats.flush_latency.record(time.perf_counter() - t0)

    def _flush_compute(self, ids: list, vecs: list) -> None:
        """Insert one drained buffer into the RW tier, ``insert_batch``
        points per ``insert_edges_stage`` + ``insert_apply_delta``: in
        arrival order, or with ``locality_order`` the whole buffer
        proximity-ordered first (seeded per flush; the order is computed on
        the CPU, so the CPU and the card take the same one).  Ext-id rows
        are written before the new state is published."""
        B = self.cfg.insert_batch
        dev = self.device
        if self.cfg.locality_order and len(ids) > 1:
            perm = locality_order(
                torch.from_numpy(np.stack(vecs)),
                n_clusters=self.cfg.index.locality_clusters or 16,
                seed=self._flush_seq).tolist()
            ids = [ids[i] for i in perm]
            vecs = [vecs[i] for i in perm]
        self._flush_seq += 1
        t = self.rw
        for lo in range(0, len(ids), B):
            chunk_i = ids[lo:lo + B]
            chunk_v = vecs[lo:lo + B]
            slots = np.arange(t.n, t.n + len(chunk_i), dtype=np.int32)
            if t.n == 0:
                # Seed the empty temp graph: the first point is the start.
                st = t.state
                st.vectors[0] = torch.as_tensor(chunk_v[0]).to(
                    dev, st.vectors.dtype)
                st.active[0] = True
                t.ext_ids[0] = chunk_i[0]
                t.state = st._replace(
                    start=torch.zeros((), dtype=torch.int32, device=dev),
                    n_total=torch.ones((), dtype=torch.int32, device=dev))
                self._ext_loc[chunk_i[0]] = ("rw", 0)
                chunk_i, chunk_v, slots = chunk_i[1:], chunk_v[1:], slots[1:]
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
    ready-made ``codebook``)."""
    if labels is not None or tenants is not None:
        raise NotImplementedError(
            "labelled bootstrap points are not ported to repro_torch yet; "
            "they come with the filters slice")
    check_ported(cfg)
    lti = build_lti(vectors, cfg.index, cfg.pq, device=device, **build_kw)
    table = np.full(cfg.index.capacity, -1, np.int64)
    table[:len(ext_ids)] = ext_ids
    return FreshDiskANN(cfg, lti=lti, lti_ext_ids=table, device=device)
