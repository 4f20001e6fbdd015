"""The FreshDiskANN system (paper §5): LTI + RW/RO TempIndex + DeleteList,
PyTorch port of the main path of ``core/system.py``.

This slice runs: the bootstrap build of the LTI, streaming inserts buffered
and flushed into the RW TempIndex in arrival order, RW -> RO rollover,
deletes into the DeleteList, and ``search_batch`` through the one-call
§5.2 fan-out (``index.unified_search``) with ``batch_queries`` chunking.
Everything lives on one device (CUDA unless the caller asks for the CPU).

Not in this slice, and raising ``NotImplementedError`` naming the slice
that ports it: StreamingMerge (``merge()``, reaching ``merge_threshold``,
``background_merge``), the WAL and snapshots (``wal_dir``,
``snapshot_dir``), the disk layout (``storage_dir``), the sharded LTI lane
(``shard_lti``), filters and tenants (``filter_words``, ``labels``,
``tenant``), locality ordering (``locality_order``), the beam-width
autotuner (``autotune_beam``) and the sequential per-tier query path
(``batch_fanout=False``).  The class is not thread-safe in this slice: the
locks of the reference guard its background merge, which comes with the
merge slice.

External ids are user-provided int64s; the system maps them to
(tier, slot).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import index as mem
from . import pq as pqm
from .config import SystemConfig, resolve_device
from .distance import INVALID
from .graph import GraphState, empty_graph, pad_graph, stack_lanes
from .lti import LTIState, build_lti

MERGE_SLICE = "the merge slice (StreamingMerge and delete consolidation)"
_UNPORTED = (
    ("wal_dir", None, "the WAL and snapshot slice"),
    ("snapshot_dir", None, "the WAL and snapshot slice"),
    ("storage_dir", None, "the storage slice"),
    ("shard_lti", 0, "the serving and sharding slice"),
    ("filter_words", 0, "the filters slice"),
    ("locality_order", False, MERGE_SLICE),
    ("background_merge", False, MERGE_SLICE),
    ("autotune_beam", False, "the autotune slice"),
    ("batch_fanout", True,
     "the serving and sharding slice, with the "
     "sequential per-tier query path"),
)


def check_ported(cfg: SystemConfig) -> None:
    """Raise ``NotImplementedError`` for a knob this slice does not run."""
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
    """The reference's counters that this slice's path updates (same names
    and meanings)."""
    inserts: int = 0
    deletes: int = 0
    searches: int = 0            # queries served
    snapshots: int = 0           # RW -> RO rollovers
    search_dispatches: int = 0   # unified fan-out calls (one per micro-batch)
    flushes: int = 0
    flush_backedge_targets: int = 0  # distinct Delta targets across flushes
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
        # Fan-out caches keyed by tier-state identity (a flush or rollover
        # replaces the state object) and, for the drop mask, the DeleteList
        # epoch (bumped on every DeleteList change).
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
        if e in self._insert_buf_id:
            # Only buffered: drop it there, or the next flush would revive
            # it and invert the op order.
            keep = [i for i, x in enumerate(self._insert_buf_id) if x != e]
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

    def merge(self, background: bool = False) -> None:
        raise NotImplementedError(
            f"StreamingMerge is not ported to repro_torch yet; it comes "
            f"with {MERGE_SLICE}")

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
        """Every searchable tier: (RW or None, live RO tiers, LTI entry)."""
        rw_t = self.rw if self.rw.n > 0 else None
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
        """Land the insert buffer in the RW tier."""
        if not self._insert_buf_id:
            return
        ids, vecs = self._insert_buf_id, self._insert_buf_v
        self._insert_buf_id, self._insert_buf_v = [], []
        t0 = time.perf_counter()
        self._flush_compute(ids, vecs)
        self.stats.flushes += 1
        self.stats.flush_latency.record(time.perf_counter() - t0)

    def _flush_compute(self, ids: list, vecs: list) -> None:
        """Insert one drained buffer into the RW tier in arrival order,
        ``insert_batch`` points per ``insert_edges_stage`` +
        ``insert_apply_delta``.  Ext-id rows are written before the new
        state is published."""
        B = self.cfg.insert_batch
        dev = self.device
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
        ``ro_snapshot_points``; reaching ``merge_threshold`` staged points
        would start a StreamingMerge, which is not in this slice."""
        if self.rw.n >= self.cfg.ro_snapshot_points:
            self._flush_inserts()
            frozen = self.rw
            self.ro.append(frozen)
            self.rw = self._new_temp()
            for slot in np.nonzero(frozen.ext_ids >= 0)[0]:
                e = int(frozen.ext_ids[slot])
                if self._ext_loc.get(e) == ("rw", int(slot)):
                    self._ext_loc[e] = ("ro", int(slot))
            self.stats.snapshots += 1
        staged = sum(t.n for t in self.ro)
        if staged >= self.cfg.merge_threshold:
            self.merge()

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
