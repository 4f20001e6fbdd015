"""The async prefetch pipeline (double-buffered lookahead adjacency reads)
and the device-resident graph source, PyTorch port of
``storage/prefetch.py``.

A beam search cannot know its next frontier before this round's distances
land, but the engine can name the next ``depth * W`` still-open candidates
(``core.search._lookahead``): unless a fresh discovery outranks them, the
next frontier is drawn from them.  The engine ships that hint with every
row fetch, and ``Prefetcher`` reads those rows from ``topology.bin`` on a
worker thread while the device scores the current round.

Staging is double-buffered and allocation-free in steady state: two host
buffers are allocated once (grown only if a larger hint batch arrives,
counted in ``allocations``) and generations alternate between them.  They
are plain numpy, as the reference's.

``hbm_gather_rows`` is the device side of the storage tier, where "disk"
is device memory: the row gather ``table[ids]`` through the hand-written
``gather_rows`` kernel (``kernels/csrc/gather_rows.cu``), served to the
beam engine by ``HBMSource``.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels import ops


class Prefetcher:
    """Background lookahead reader with two reusable staging buffers.

    ``fetch_batch(ids [n] int, out [>=n, R] int32) -> was_file_read [n]``
    comes from the ``DiskReader``: one vectorised gather per staged
    generation, through the shared block cache (a hinted row whose block is
    cached is staged without a file read and counts as a cache hit).

    Protocol, driven by ``DiskReader.fetch`` once per IO round:
      1. ``wait()``     -- block until the in-flight generation is staged;
      2. ``lookup(id)`` -- serve staged rows for the current round;
      3. ``submit(ids)``-- start staging the next round's hints on the
                           worker thread and return at once.
    Generations alternate buffers, and a generation is consumed only after
    its fill completed and before the next submit, so two buffers suffice.
    """

    def __init__(self, fetch_batch: Callable, R: int):
        self.R = int(R)
        self._fetch_batch = fetch_batch
        self._buffers = [np.empty((0, self.R), np.int32),
                         np.empty((0, self.R), np.int32)]
        self.allocations = 0            # staging (re)allocations; quiet
        #   after warm-up (the buffer-reuse contract)
        self._gen = 0
        self._map: dict[int, tuple[int, bool]] = {}   # id -> (slot, read?)
        self._cur: Optional[np.ndarray] = None
        self._done = threading.Event()
        self._done.set()
        self._queue: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def staging_buffers(self) -> tuple[np.ndarray, np.ndarray]:
        """The two staging buffers (identity-stable across rounds)."""
        return tuple(self._buffers)

    def submit(self, ids: np.ndarray) -> None:
        """Stage ``ids`` (unique, valid) on the worker; returns at once."""
        self._done.wait()               # never overwrite an in-flight fill
        prev = (self._map, self._cur)   # carry-over source (see _worker)
        self._gen += 1
        bi = self._gen & 1
        n = len(ids)
        if self._buffers[bi].shape[0] < n:
            # Geometric growth, and growth only: after warm-up every round
            # reuses the same two arrays.
            cap = max(n, 64, 2 * self._buffers[bi].shape[0])
            self._buffers[bi] = np.empty((cap, self.R), np.int32)
            self.allocations += 1
        self._map = {}
        self._cur = self._buffers[bi]
        self._done.clear()
        self._queue.put((bi, np.asarray(ids, np.int64), prev))

    def wait(self) -> None:
        self._done.wait()

    def lookup(self, node_id: int):
        """(row, was_file_read) if staged in the current generation, else
        None.  Call only after ``wait()``."""
        e = self._map.get(node_id)
        if e is None:
            return None
        return self._cur[e[0]], e[1]

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=5)

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            bi, ids, (prev_map, prev_buf) = item
            buf = self._buffers[bi]
            # The fill target is one of the two owned staging arrays.
            assert buf is self._buffers[bi]
            m = {}
            if len(ids):
                # Carry-over: a hint that missed last round is usually
                # hinted again; its row still sits in the other buffer, so
                # it is copied across (with its was-file-read flag) instead
                # of read again.
                carried, new_ids = [], []
                for nid in ids:
                    e = prev_map.get(int(nid))
                    if e is None:
                        new_ids.append(nid)
                    else:
                        carried.append((int(nid), e))
                nn = len(new_ids)
                if nn:
                    na = np.asarray(new_ids, np.int64)
                    was = self._fetch_batch(na, buf)
                    m = {int(nid): (j, bool(was[j]))
                         for j, nid in enumerate(na)}
                for j, (nid, e) in enumerate(carried):
                    buf[nn + j] = prev_buf[e[0]]
                    m[nid] = (nn + j, e[1])
            self._map = m
            self._done.set()


def hbm_gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for table [N, R] int32 and ids [..., W] int32, with
    INVALID rows where ``ids < 0`` -> [..., W, R] (the ``gather_rows``
    kernel on a CUDA tensor, its plain version on the CPU).  Bit-identical
    to ``DenseSource.rows``."""
    return ops.gather_rows(table, ids)


class HBMSource:
    """``GraphSource`` whose row gathers run through ``hbm_gather_rows``:
    the storage tier's face with the graph resident in device memory.
    Bit-identical to ``DenseSource``."""

    def __init__(self, adjacency: torch.Tensor, navigable: torch.Tensor):
        self.adjacency = adjacency
        self.navigable = navigable

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        return hbm_gather_rows(self.adjacency, ids.contiguous())

    def node_ok(self, ids: torch.Tensor) -> torch.Tensor:
        return (ids >= 0) & self.navigable[ids.clamp(min=0).long()]
