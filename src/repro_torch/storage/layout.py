"""Decoupled on-disk index layout: topology split from vectors (DGAI-style),
PyTorch port of ``storage/layout.py``.

The LTI on "disk" is a directory of four files, byte-compatible with the
reference's, so either package opens the other's layouts:

  ``header.json``    capacity / R / dim / m / dtype / start / n_total /
                     generation; rewritten last (tmp + atomic rename), so
                     the generation only advances once a patch is on disk.
  ``topology.bin``   int32 [capacity, R], fixed stride of R*4 bytes: row i
                     is bytes [i*R*4, (i+1)*R*4).
  ``data.bin``       float32 [capacity, dim] vectors, then uint8
                     [capacity, m] PQ codes.  Topology-only updates never
                     touch it.
  ``meta.npz``       the small side tables loaded whole at open: ``active``,
                     ``deleted``, ``ext_ids``, the PQ ``centroids``, and the
                     label tables ``label_bits`` (uint32 [capacity, words])
                     and ``label_tenant`` (int32 [capacity]).

Graph arguments are the port's ``GraphState`` (torch tensors on any
device) or anything whose fields ``np.asarray`` reads; ``graph_state`` and
``lti_state`` hand a layout back as the port's states on a named device.
``write_layout`` stages into ``<path>.tmp`` and publishes with
``checkpoint.store.commit_dir``; ``patch_layout`` rewrites only the rows
that changed, in place, then bumps the header generation.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..checkpoint.store import commit_dir, fsync_dir

LAYOUT_VERSION = 1
HEADER = "header.json"
TOPOLOGY = "topology.bin"
DATA = "data.bin"
META = "meta.npz"

# Granularity of the adjacency-block cache and of read accounting: a block
# is BLOCK_BYTES of topology.bin (the paper's 4 KB SSD sector).
BLOCK_BYTES = 4096


def host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class PatchStats:
    """What a delta patch wrote (folded into ``SystemStats``)."""
    adj_rows: int = 0
    adj_blocks: int = 0     # distinct 4 KB topology blocks of those rows
    vec_rows: int = 0
    code_rows: int = 0
    bytes_written: int = 0
    generation: int = 0


@dataclasses.dataclass
class StorageLayout:
    """An open decoupled layout: mmap views + in-memory side tables."""
    path: str
    capacity: int
    R: int
    dim: int
    m: int
    vec_dtype: str
    start: int
    n_total: int
    generation: int
    adjacency: np.memmap        # [capacity, R] int32
    vectors: np.memmap          # [capacity, dim] vec_dtype
    codes: Optional[np.memmap]  # [capacity, m] uint8, None when m == 0
    active: np.ndarray          # [capacity] bool
    deleted: np.ndarray         # [capacity] bool
    ext_ids: np.ndarray         # [capacity] int64, -1 free
    centroids: Optional[np.ndarray]  # [m, ksub, dsub] f32 PQ codebook
    label_bits: Optional[np.ndarray] = None   # [capacity, n_words] uint32
    label_tenant: Optional[np.ndarray] = None  # [capacity] int32, -1 none

    @property
    def row_bytes(self) -> int:
        return self.R * 4

    @property
    def block_rows(self) -> int:
        """Adjacency rows per cache/IO block (>= 1)."""
        return max(1, BLOCK_BYTES // self.row_bytes)

    def graph_state(self, device="cuda"):
        """The whole graph as the port's ``GraphState`` on ``device``
        (recovery and tests; serving reads rows through ``DiskSource``)."""
        from ..core.config import resolve_device
        from ..core.graph import GraphState
        dev = resolve_device(device)

        def t(x, dt=None):
            return torch.from_numpy(np.array(x, dtype=dt)).to(dev)

        return GraphState(
            vectors=t(self.vectors, np.float32),
            adjacency=t(self.adjacency, np.int32),
            active=t(self.active, np.bool_),
            deleted=t(self.deleted, np.bool_),
            start=t(self.start, np.int32),
            n_total=t(self.n_total, np.int32))

    def lti_state(self, device="cuda"):
        """The whole LTI (codes and codebook required) on ``device``."""
        from ..core.config import resolve_device
        from ..core.lti import LTIState
        from ..core.pq import PQCodebook
        if self.codes is None or self.centroids is None:
            raise ValueError(f"layout at {self.path} has no PQ codes")
        dev = resolve_device(device)
        return LTIState(
            self.graph_state(dev),
            torch.from_numpy(np.array(self.codes, np.uint8)).to(dev),
            PQCodebook(torch.from_numpy(
                np.array(self.centroids, np.float32)).to(dev)))

    def close(self) -> None:
        # memmaps release on GC; drop the references deterministically.
        self.adjacency = self.vectors = self.codes = None


def _header_dict(capacity, R, dim, m, vec_dtype, start, n_total, generation):
    return {"version": LAYOUT_VERSION, "capacity": int(capacity),
            "R": int(R), "dim": int(dim), "m": int(m),
            "vec_dtype": str(vec_dtype), "start": int(start),
            "n_total": int(n_total), "generation": int(generation)}


def _write_header(path: str, hdr: dict) -> None:
    """Publish the header last, atomically: tmp + fsync + rename."""
    tmp = os.path.join(path, HEADER + ".tmp")
    with open(tmp, "w") as f:
        json.dump(hdr, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, HEADER))
    fsync_dir(path)


def _write_meta(path: str, active, deleted, ext_ids, centroids,
                label_bits=None, label_tenant=None) -> None:
    tmp = os.path.join(path, META + ".tmp")
    blobs = {"active": np.asarray(active, bool),
             "deleted": np.asarray(deleted, bool),
             "ext_ids": np.asarray(ext_ids, np.int64)}
    if centroids is not None:
        blobs["centroids"] = np.asarray(centroids, np.float32)
    if label_bits is not None:
        blobs["label_bits"] = np.asarray(label_bits, np.uint32)
    if label_tenant is not None:
        blobs["label_tenant"] = np.asarray(label_tenant, np.int32)
    with open(tmp, "wb") as f:
        np.savez(f, **blobs)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, META))


def write_layout(path: str, graph, *, codes=None, codebook=None,
                 ext_ids: Optional[np.ndarray] = None,
                 generation: int = 0,
                 label_bits: Optional[np.ndarray] = None,
                 label_tenant: Optional[np.ndarray] = None) -> StorageLayout:
    """Serialise a graph (plus optional PQ codes and codebook) into a fresh
    layout at ``path`` and return it opened.  Stages into ``<path>.tmp``
    and publishes atomically, so a crash mid-write never leaves a
    half-layout at ``path``."""
    adj = np.ascontiguousarray(host(graph.adjacency).astype(np.int32,
                                                             copy=False))
    vecs = np.ascontiguousarray(host(graph.vectors))
    capacity, R = adj.shape
    cd = None if codes is None else np.ascontiguousarray(
        host(codes).astype(np.uint8, copy=False))
    m = 0 if cd is None else cd.shape[1]
    cents = None
    if codebook is not None:
        cents = host(getattr(codebook, "centroids", codebook)).astype(
            np.float32)
    if ext_ids is None:
        ext_ids = np.full(capacity, -1, np.int64)

    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, TOPOLOGY), "wb") as f:
        f.write(adj.tobytes())
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, DATA), "wb") as f:
        f.write(vecs.tobytes())
        if cd is not None:
            f.write(cd.tobytes())
        f.flush()
        os.fsync(f.fileno())
    _write_meta(tmp, host(graph.active), host(graph.deleted), ext_ids, cents,
                label_bits, label_tenant)
    hdr = _header_dict(capacity, R, vecs.shape[1], m, vecs.dtype.name,
                       int(graph.start), int(graph.n_total), generation)
    with open(os.path.join(tmp, HEADER), "w") as f:
        json.dump(hdr, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    commit_dir(tmp, path)
    return open_layout(path)


def is_layout(path: str) -> bool:
    return os.path.isfile(os.path.join(path, HEADER))


def open_layout(path: str, mode: str = "r") -> StorageLayout:
    """mmap an existing layout (``mode="r+"`` for in-place patching)."""
    with open(os.path.join(path, HEADER)) as f:
        hdr = json.load(f)
    if hdr["version"] != LAYOUT_VERSION:
        raise ValueError(f"layout version {hdr['version']} != "
                         f"{LAYOUT_VERSION} at {path}")
    cap, R, dim, m = hdr["capacity"], hdr["R"], hdr["dim"], hdr["m"]
    vdt = np.dtype(hdr["vec_dtype"])
    adjacency = np.memmap(os.path.join(path, TOPOLOGY), np.int32, mode,
                          shape=(cap, R))
    vectors = np.memmap(os.path.join(path, DATA), vdt, mode,
                        shape=(cap, dim))
    codes = None
    if m:
        codes = np.memmap(os.path.join(path, DATA), np.uint8, mode,
                          offset=cap * dim * vdt.itemsize, shape=(cap, m))
    with np.load(os.path.join(path, META)) as meta:
        def opt(key):
            return meta[key].copy() if key in meta.files else None
        active = meta["active"].copy()
        deleted = meta["deleted"].copy()
        ext_ids = meta["ext_ids"].copy()
        centroids = opt("centroids")
        label_bits = opt("label_bits")
        label_tenant = opt("label_tenant")
    return StorageLayout(
        path=path, capacity=cap, R=R, dim=dim, m=m,
        vec_dtype=hdr["vec_dtype"], start=hdr["start"],
        n_total=hdr["n_total"], generation=hdr["generation"],
        adjacency=adjacency, vectors=vectors, codes=codes,
        active=active, deleted=deleted, ext_ids=ext_ids,
        centroids=centroids, label_bits=label_bits,
        label_tenant=label_tenant)


def patch_layout(path: str, graph, *, codes=None, ext_ids=None,
                 adj_changed: Optional[np.ndarray] = None,
                 label_bits: Optional[np.ndarray] = None,
                 label_tenant: Optional[np.ndarray] = None) -> PatchStats:
    """DGAI-style delta patch: rewrite only the adjacency rows that differ
    from what is on disk (and the vector and code rows that changed),
    update the side tables, and bump the header generation last -- a reader
    opening mid-patch sees at worst the old generation over whole rows.

    ``adj_changed`` (bool [capacity]) is the caller's changed-row mask
    (e.g. ``merge.adjacency_delta_mask``); without it the rows are compared
    against the mapped file.  Vector and code rows are always compared, so
    a topology-only update measurably writes zero vector bytes.

    Unlike the reference, which writes the changed rows one by one in a
    Python loop, each file's changed rows are written with one
    fancy-indexed assignment into the memmap; the bytes on disk and the
    returned ``PatchStats`` are the same.
    """
    lay = open_layout(path, mode="r+")
    try:
        adj = host(graph.adjacency).astype(np.int32, copy=False)
        vecs = host(graph.vectors)
        if adj.shape != lay.adjacency.shape:
            raise ValueError(
                f"patch shape {adj.shape} != layout {lay.adjacency.shape}")
        if adj_changed is None:
            adj_changed = np.any(lay.adjacency != adj, axis=1)
        else:
            adj_changed = np.asarray(adj_changed, bool)
        vec_changed = np.any(np.asarray(lay.vectors) != vecs, axis=1)
        stats = PatchStats(generation=lay.generation + 1)
        rows = np.nonzero(adj_changed)[0]
        lay.adjacency[rows] = adj[rows]
        stats.adj_rows = int(rows.size)
        stats.adj_blocks = int(np.unique(rows // lay.block_rows).size)
        stats.bytes_written += stats.adj_rows * lay.row_bytes
        rows = np.nonzero(vec_changed)[0]
        lay.vectors[rows] = vecs[rows]
        stats.vec_rows = int(rows.size)
        stats.bytes_written += stats.vec_rows * vecs.shape[1] * vecs.itemsize
        if codes is not None and lay.codes is not None:
            cd = host(codes).astype(np.uint8, copy=False)
            rows = np.nonzero(np.any(np.asarray(lay.codes) != cd, axis=1))[0]
            lay.codes[rows] = cd[rows]
            stats.code_rows = int(rows.size)
            stats.bytes_written += stats.code_rows * cd.shape[1]
            lay.codes.flush()
        lay.adjacency.flush()
        lay.vectors.flush()
        _write_meta(path, host(graph.active), host(graph.deleted),
                    ext_ids if ext_ids is not None else lay.ext_ids,
                    lay.centroids,
                    label_bits if label_bits is not None else lay.label_bits,
                    label_tenant if label_tenant is not None
                    else lay.label_tenant)
        _write_header(path, _header_dict(
            lay.capacity, lay.R, lay.dim, lay.m, lay.vec_dtype,
            int(graph.start), int(graph.n_total), stats.generation))
        return stats
    finally:
        lay.close()
