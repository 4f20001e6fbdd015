"""Block-granular LRU cache over the adjacency file (PyTorch port of
``storage/cache.py``; host-side, numpy only).

The cache unit is one ``layout.BLOCK_BYTES`` block of ``topology.bin``
(``block_rows`` adjacency rows, the paper's 4 KB sector), not a single row:
an SSD read returns the whole sector, so row granularity would mis-model
hit rates and read amplification.  Eviction is strict LRU over one ordered
dict; the reader serialises demand fetches and prefetch fills, and the lock
below makes that a safety net rather than a requirement.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np


class AdjacencyCache:
    """Thread-safe LRU of adjacency blocks, bounded by bytes."""

    def __init__(self, capacity_bytes: int, block_bytes: int):
        self.capacity_blocks = max(0, int(capacity_bytes) // int(block_bytes))
        self.block_bytes = int(block_bytes)
        self._blocks: OrderedDict[int, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.capacity_blocks > 0

    def get(self, block_id: int):
        """The cached block (rows [block_rows, R] int32) or None; a hit
        refreshes its recency."""
        with self._lock:
            blk = self._blocks.get(block_id)
            if blk is not None:
                self._blocks.move_to_end(block_id)
            return blk

    def put(self, block_id: int, block: np.ndarray) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._blocks[block_id] = block
            self._blocks.move_to_end(block_id)
            while len(self._blocks) > self.capacity_blocks:
                self._blocks.popitem(last=False)
