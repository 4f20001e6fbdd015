"""``DiskSource`` -- the on-disk sibling of ``core.search.DenseSource`` --
and the disk-backed LTI searcher, PyTorch port of ``storage/source.py``.

The beam engine's topology reads go through the ``GraphSource`` protocol;
this module implements it over a decoupled layout (``storage.layout``).
The engine is an eager loop, so where the reference crossed into the host
with ``jax.pure_callback`` each round, ``DiskSource.rows_hinted`` calls the
host reader directly: the round's [B, W] frontier and [B, H] hints go to
the host in one copy, the reader serves the rows from the block cache, the
prefetch staging or ``topology.bin``, and the rows with their per-row
``fetched`` mask come back to the device in one copy.

Read accounting (the ``n_reads`` contract of ``core/search.py``):

  fetched=True   the row came off the file for this request: a demand read,
                 or a prefetch-staged row whose block the worker read.
  fetched=False  the row cost no file IO for this request: its block was in
                 the LRU cache.  Counted in ``IOStats.cache_hits``.

So with the cache off ``n_reads`` equals the dense engine's at any
prefetch depth, and with the cache on ``n_reads + cache_hits`` does.
Node validity and the slot -> external-id table come from the layout's
in-memory side tables, never from the file.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core import pq as pqm
from ..core.config import IndexConfig, resolve_device
from ..core.distance import INVALID, l2_sq
from ..core.search import (PQBackend, batch_distances, beam_search,
                           rerank_candidates, topk_results)
from ..kernels import ops
from .cache import AdjacencyCache
from .layout import StorageLayout
from .prefetch import Prefetcher

# Simulated device concurrency: block reads issued together ride the queue
# QUEUE_DEPTH at a time, so a batch of B blocks costs ceil(B / QUEUE_DEPTH)
# round trips of ``latency_us`` (the §6.2 model of concurrent sector reads).
QUEUE_DEPTH = 8


@dataclasses.dataclass
class IOStats:
    """Host-side IO accounting of one ``DiskReader`` (monotonic; the system
    folds deltas into ``SystemStats``)."""
    rows_requested: int = 0     # valid adjacency rows the engine asked for
    demand_reads: int = 0       # rows served by a synchronous file read
    prefetch_hits: int = 0      # rows served from prefetch staging whose
    #   block the worker read from the file (overlapped IO, still a read)
    cache_hits: int = 0         # rows served with no file IO for the request
    blocks_read: int = 0        # topology.bin block reads, all causes
    prefetch_blocks: int = 0    # ... of which issued by the worker thread
    bytes_read: int = 0         # topology.bin bytes off the file
    vector_rows: int = 0        # full-precision rows gathered for rerank
    vector_bytes: int = 0
    fetch_calls: int = 0        # row fetches (== IO rounds, batched)

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class DiskReader:
    """Host-side row server over an open layout: block cache + prefetch
    staging + mmap'd ``topology.bin``, with deterministic accounting.

    ``latency_us`` simulates device latency per queue submission: a batch
    of B distinct blocks costs ceil(B / QUEUE_DEPTH) round trips, slept on
    the thread that ran the batch (the caller's for demand reads, the
    worker's for prefetches).  0 (the default) adds nothing.
    """

    def __init__(self, layout: StorageLayout, *, cache_mb: int = 0,
                 prefetch: bool = False, latency_us: float = 0.0):
        self.layout = layout
        self.row_bytes = layout.row_bytes
        self.block_rows = layout.block_rows
        self.block_bytes = self.block_rows * self.row_bytes
        self.latency_s = latency_us * 1e-6
        self.cache = AdjacencyCache(cache_mb * (1 << 20), self.block_bytes)
        self.stats = IOStats()
        self._io_lock = threading.Lock()
        self.prefetcher = (Prefetcher(self._serve_prefetch, layout.R)
                           if prefetch else None)

    def _read_block(self, block_id: int, *, prefetch: bool) -> np.ndarray:
        """One block off topology.bin (a sector read)."""
        lo = block_id * self.block_rows
        hi = min(lo + self.block_rows, self.layout.capacity)
        blk = np.asarray(self.layout.adjacency[lo:hi])
        self.stats.blocks_read += 1
        self.stats.bytes_read += self.block_bytes
        if prefetch:
            self.stats.prefetch_blocks += 1
        return blk

    def _serve_batch(self, ids: np.ndarray, *, prefetch: bool,
                     out: Optional[np.ndarray] = None):
        """(rows [n, R], was_file_read [n]) for valid ``ids``, under one
        lock hold (the batch is one queue submission); the simulated
        latency is slept after the lock drops."""
        n = ids.shape[0]
        rows = out if out is not None else np.empty(
            (n, self.layout.R), np.int32)
        dst = rows[:n]          # view: ``out`` may be an oversized buffer
        was = np.zeros(n, bool)
        bs = ids // self.block_rows
        nb = 0
        with self._io_lock:
            if not self.cache.enabled:
                dst[:] = self.layout.adjacency[ids]
                nb = len(np.unique(bs))
                self.stats.blocks_read += nb
                self.stats.bytes_read += nb * self.block_bytes
                if prefetch:
                    self.stats.prefetch_blocks += nb
                was[:] = True
            else:
                for b in np.unique(bs):
                    sel = bs == b
                    blk = self.cache.get(int(b))
                    if blk is None:
                        blk = self._read_block(int(b), prefetch=prefetch)
                        self.cache.put(int(b), blk)
                        was[sel] = True
                        nb += 1
                    dst[sel] = blk[ids[sel] - int(b) * self.block_rows]
        if nb and self.latency_s:
            time.sleep(self.latency_s * -(-nb // QUEUE_DEPTH))
        return rows, was

    def _serve_prefetch(self, ids: np.ndarray, out: np.ndarray) -> np.ndarray:
        """The prefetch worker's staging gather into the staging buffer;
        returns the per-row file-read mask."""
        return self._serve_batch(ids, prefetch=True, out=out)[1]

    def fetch(self, ids, hints):
        """One IO round: ids [..., W] frontier, hints [..., H] lookahead
        (host int arrays) -> (rows [..., W, R] int32, fetched [..., W]
        bool).

        Order: (1) wait out the in-flight prefetch generation; (2) serve
        the frontier rows that are staged; (3) submit the next hints before
        (4) the synchronous demand read of the rest, so the worker's IO for
        the next round overlaps this round's.  Every row is classified once,
        so the conservation law holds under any interleaving, and with the
        cache off every row is a read.
        """
        ids = np.asarray(ids)
        hints = np.asarray(hints)
        R = self.layout.R
        fids = ids.reshape(-1)
        rows = np.full((fids.shape[0], R), INVALID, np.int32)
        fetched = np.zeros(fids.shape[0], bool)
        pf = self.prefetcher
        if pf is not None:
            pf.wait()
        self.stats.fetch_calls += 1
        valid = np.nonzero(fids >= 0)[0]
        self.stats.rows_requested += len(valid)
        if pf is not None:
            demand = []
            for i in valid:
                staged = pf.lookup(int(fids[i]))
                if staged is None:
                    demand.append(i)
                    continue
                row, was_read = staged
                if was_read:
                    self.stats.prefetch_hits += 1
                else:
                    self.stats.cache_hits += 1
                rows[i] = row
                fetched[i] = was_read
            demand = np.asarray(demand, np.int64)
        else:
            demand = valid
        if pf is not None and hints.size:
            h = np.unique(hints.reshape(-1))
            pf.submit(h[h >= 0])
        if demand.size:
            r, was = self._serve_batch(fids[demand].astype(np.int64),
                                       prefetch=False)
            rows[demand] = r
            fetched[demand] = was
            self.stats.demand_reads += int(was.sum())
            self.stats.cache_hits += int((~was).sum())
        return (rows.reshape(ids.shape + (R,)),
                fetched.reshape(ids.shape))

    def fetch_vectors(self, ids):
        """Rerank gather from the vector region of ``data.bin``: ids
        [..., K] -> rows [..., K, dim] float32 (zeros for ids < 0)."""
        ids = np.asarray(ids)
        dim = self.layout.dim
        flat = ids.reshape(-1)
        out = np.zeros((flat.shape[0], dim), np.float32)
        ok = flat >= 0
        if ok.any():
            out[ok] = np.asarray(self.layout.vectors[flat[ok]], np.float32)
            self.stats.vector_rows += int(ok.sum())
            self.stats.vector_bytes += int(ok.sum()) * dim * 4
        return out.reshape(ids.shape + (dim,))

    def close(self) -> None:
        if self.prefetcher is not None:
            self.prefetcher.close()


class DiskSource:
    """``GraphSource`` over a ``DiskReader`` with the hinted extension:
    ``hint_width`` > 0 makes the engine thread a ``depth * W``-wide
    lookahead through the loop; the presence of ``rows_hinted`` (not the
    width) routes it onto the counted-reads path, so depth 0 still gets
    exact disk accounting."""

    def __init__(self, reader: DiskReader, navigable: torch.Tensor,
                 hint_width: int = 0):
        self.reader = reader
        self.navigable = navigable
        self.hint_width = int(hint_width)
        self.R = reader.layout.R

    def rows_hinted(self, ids: torch.Tensor, hints: torch.Tensor):
        """ids [B, W], hints [B, H] (device) -> (rows [B, W, R] int32,
        fetched [B, W] bool) on the device: one copy to the host, one
        back."""
        B, W = ids.shape
        R = self.R
        both = torch.cat([ids, hints], 1).cpu().numpy()
        rows, fetched = self.reader.fetch(both[:, :W], both[:, W:])
        packed = np.concatenate([rows.reshape(B, W * R),
                                 fetched.astype(np.int32)], 1)
        back = torch.from_numpy(packed).to(ids.device)
        return (back[:, :W * R].reshape(B, W, R).contiguous(),
                back[:, W * R:].bool())

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        return self.rows_hinted(ids, ids[:, :0])[0]

    def node_ok(self, ids: torch.Tensor) -> torch.Tensor:
        # Validity comes from the in-memory side table, never an IO.
        return (ids >= 0) & self.navigable[ids.clamp(min=0).long()]


class DiskVectorBackend:
    """``FullPrecisionBackend`` over the on-disk vector file (the exact
    rerank's full-precision rows, fetched from the capacity tier).

    Routing differs from the reference, which always uses ``l2_sq``: like
    the port's ``FullPrecisionBackend`` this uses the ``l2_rows`` kernel
    when ``use_kernel`` (over the fetched [B*K, dim] rows) and ``l2_sq``
    when not, so ``search_disk`` equals ``search_batch`` bit for bit on the
    card and equals the reference on the CPU."""

    def __init__(self, reader: DiskReader):
        self.reader = reader
        self.dim = reader.layout.dim

    def prepare(self, queries: torch.Tensor) -> torch.Tensor:
        return queries.float().contiguous()

    def distances(self, ctx: torch.Tensor, ids: torch.Tensor, *,
                  use_kernel: bool = False) -> torch.Tensor:
        """ids [B, K] int32 (INVALID-padded) -> [B, K] f32 (+inf)."""
        B, K = ids.shape
        pts = torch.from_numpy(self.reader.fetch_vectors(
            ids.cpu().numpy())).to(ids.device)              # [B, K, dim]
        if use_kernel:
            rows = torch.arange(B * K, dtype=torch.int32,
                                device=ids.device).reshape(B, K)
            rows = torch.where(ids >= 0, rows, INVALID)
            return ops.l2_rows(ctx, pts.reshape(B * K, self.dim), rows)
        d = l2_sq(ctx[:, None, :], pts)
        return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


class DiskLTISearcher:
    """PQ-navigated beam search whose topology reads come off the layout:
    the disk-backed twin of ``core.lti.search_lti``.

    Navigation distances use the in-memory PQ codes on the device,
    adjacency rows stream from ``topology.bin`` through the cache and the
    prefetch pipeline, and the exact rerank reads ``data.bin``.  With the
    cache off the results (ids, dists, hops, cmps and reads) equal
    ``search_lti`` on the same state.  Open one searcher per layout
    generation and reuse it across query batches.
    """

    def __init__(self, layout: StorageLayout, cfg: IndexConfig, *,
                 cache_mb: int = 0, prefetch_depth: int = 0,
                 latency_us: float = 0.0, device="cuda"):
        if layout.codes is None or layout.centroids is None:
            raise ValueError("DiskLTISearcher needs a layout with PQ codes")
        self.layout = layout
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prefetch_depth = int(prefetch_depth)
        self.reader = DiskReader(layout, cache_mb=cache_mb,
                                 prefetch=prefetch_depth > 0,
                                 latency_us=latency_us)
        dev = self.device
        # The in-memory side tables and navigation codes, on the device.
        self.active = torch.from_numpy(layout.active.copy()).to(dev)
        self.reportable = torch.from_numpy(
            layout.active & ~layout.deleted).to(dev)
        self.codes = torch.from_numpy(np.array(layout.codes)).to(dev)
        self.codebook = pqm.PQCodebook(torch.from_numpy(
            np.array(layout.centroids, np.float32)).to(dev))
        self.start = torch.tensor(layout.start, dtype=torch.int32,
                                  device=dev)

    @property
    def stats(self) -> IOStats:
        return self.reader.stats

    def search(self, queries, *, k: int, L: int,
               beam_width: Optional[int] = None, rerank: bool = True):
        """(ids [B,k], dists [B,k], hops [B], cmps [B], reads [B]) on the
        device: the ``search_lti`` tuple plus the per-query disk reads."""
        W = min(beam_width or self.cfg.beam_width, L)
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
        use_kernel = self.cfg.kernel_enabled(self.device)
        source = DiskSource(self.reader, self.active,
                            hint_width=self.prefetch_depth * W)
        res = beam_search(None, None, self.start, q,
                          PQBackend(self.codes, self.codebook), L=L,
                          max_visits=self.cfg.visits_bound(L), beam_width=W,
                          use_kernel=use_kernel, source=source,
                          R=self.layout.R)
        if rerank:
            exact = batch_distances(
                DiskVectorBackend(self.reader), q,
                rerank_candidates(res.ids, self.reportable),
                use_kernel=use_kernel)
            res = res._replace(dists=exact)
        ids, d = topk_results(res, k, self.reportable)
        return ids, d, res.n_hops, res.n_cmps, res.n_reads

    def close(self) -> None:
        self.reader.close()
