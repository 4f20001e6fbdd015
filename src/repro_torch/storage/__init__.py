"""The decoupled on-disk index layer (PyTorch port of ``repro.storage``).

``layout``    topology/vector file formats, atomic writers, delta patches.
``cache``     block-granular LRU over the adjacency file.
``prefetch``  double-buffered async lookahead reader, and ``HBMSource``
              over the ``gather_rows`` kernel (the graph in device memory).
``source``    ``DiskSource``/``DiskVectorBackend`` behind the engine's
              ``GraphSource``/backend protocols, and the disk-backed LTI
              searcher.
"""
from .cache import AdjacencyCache
from .layout import (BLOCK_BYTES, PatchStats, StorageLayout, is_layout,
                     open_layout, patch_layout, write_layout)
from .prefetch import HBMSource, Prefetcher, hbm_gather_rows
from .source import (DiskLTISearcher, DiskReader, DiskSource,
                     DiskVectorBackend, IOStats)

__all__ = [
    "AdjacencyCache", "BLOCK_BYTES", "DiskLTISearcher", "DiskReader",
    "DiskSource", "DiskVectorBackend", "HBMSource", "IOStats",
    "PatchStats", "Prefetcher", "StorageLayout", "hbm_gather_rows",
    "is_layout", "open_layout", "patch_layout", "write_layout",
]
