"""Redo log (WAL) for crash recovery (paper §5.6), PyTorch port of
``core/wal.py``.

Every user-facing mutation (an insert with its vector, a delete) is
appended to an append-only log before it is applied.  Recovery loads the
latest snapshot and replays the log suffix past it.  The file format is the
reference's, byte for byte, so either package replays the other's logs.

Record format (little-endian):
    u8 op (0=insert, 1=delete) | i64 external_id | f32[dim] vector (insert only)

Op 2 (labelled insert) carries the point's label sidecar between the id
and the vector:
    u8 op=2 | i64 ext_id | i32 tenant | u8 n_words | u32[n_words] bits
    | f32[dim] vector
``replay`` parses it; label-free systems never write it.
"""
from __future__ import annotations

import os
import struct
from typing import Iterator, NamedTuple, Optional

import numpy as np

_HDR = struct.Struct("<4sIQ")   # magic, dim, start_seqno
_REC = struct.Struct("<BQ")     # op, ext_id
_LBL = struct.Struct("<iB")     # tenant, n_words (labelled-insert sidecar)
MAGIC = b"FDWL"
OP_INSERT, OP_DELETE, OP_INSERT_LABELED = 0, 1, 2


class LabeledVec(NamedTuple):
    """Payload of an OP_INSERT_LABELED record (replay's third element)."""
    vec: np.ndarray
    tenant: int
    bits: np.ndarray  # uint32[n_words] packed label bitset


class WriteAheadLog:
    def __init__(self, path: str, dim: int, start_seqno: int = 0,
                 fsync: bool = False):
        self.path, self.dim, self.fsync = path, dim, fsync
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        # Always O_APPEND: every write lands at the real EOF even after the
        # file was truncated underneath the handle (a positional handle
        # would leave a zero-hole at its stale offset).
        self._f = open(path, "ab")
        if not exists:
            self._f.write(_HDR.pack(MAGIC, dim, start_seqno))
            self._f.flush()

    def log_insert(self, ext_id: int, vec: np.ndarray) -> None:
        self._f.write(_REC.pack(OP_INSERT, ext_id))
        self._f.write(np.asarray(vec, np.float32).tobytes())
        self._flush()

    def log_insert_labeled(self, ext_id: int, vec: np.ndarray, tenant: int,
                           bits: np.ndarray) -> None:
        bits = np.asarray(bits, np.uint32)
        self._f.write(_REC.pack(OP_INSERT_LABELED, ext_id))
        self._f.write(_LBL.pack(int(tenant), bits.size))
        self._f.write(bits.tobytes())
        self._f.write(np.asarray(vec, np.float32).tobytes())
        self._flush()

    def log_delete(self, ext_id: int) -> None:
        self._f.write(_REC.pack(OP_DELETE, ext_id))
        self._flush()

    def _flush(self):
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def restart(self, start_seqno: int) -> None:
        """Start a fresh log epoch through this handle (close, truncate,
        reopen): the only safe way to truncate a log still being written."""
        self._f.close()
        truncate(self.path, self.dim, start_seqno)
        self._f = open(self.path, "ab")

    def close(self):
        self._f.close()


def replay(path: str, start: Optional[int] = None
           ) -> Iterator[tuple[int, int, Optional[np.ndarray]]]:
    """Yield (op, ext_id, vector | LabeledVec | None) records of a log.

    ``start``: byte offset to resume from (the log's size when a snapshot
    was taken, so recovery replays only the suffix written after it).  A
    torn final record is dropped.
    """
    with open(path, "rb") as f:
        magic, dim, _ = _HDR.unpack(f.read(_HDR.size))
        if magic != MAGIC:
            raise ValueError(f"{path}: bad WAL magic")
        if start is not None and start > _HDR.size:
            f.seek(start)
        vec_bytes = 4 * dim
        while True:
            raw = f.read(_REC.size)
            if len(raw) < _REC.size:
                break
            op, ext_id = _REC.unpack(raw)
            if op == OP_INSERT:
                vraw = f.read(vec_bytes)
                if len(vraw) < vec_bytes:
                    break
                yield op, ext_id, np.frombuffer(vraw, np.float32).copy()
            elif op == OP_INSERT_LABELED:
                lraw = f.read(_LBL.size)
                if len(lraw) < _LBL.size:
                    break
                tenant, n_words = _LBL.unpack(lraw)
                braw = f.read(4 * n_words)
                vraw = f.read(vec_bytes)
                if len(braw) < 4 * n_words or len(vraw) < vec_bytes:
                    break
                yield op, ext_id, LabeledVec(
                    np.frombuffer(vraw, np.float32).copy(), tenant,
                    np.frombuffer(braw, np.uint32).copy())
            else:
                yield op, ext_id, None


def log_epoch(path: str) -> int:
    """The log's epoch counter (the header's start_seqno; bumped on each
    truncation)."""
    with open(path, "rb") as f:
        magic, _, seqno = _HDR.unpack(f.read(_HDR.size))
        if magic != MAGIC:
            raise ValueError(f"{path}: bad WAL magic")
        return seqno


def truncate(path: str, dim: int, start_seqno: int) -> None:
    """Start a fresh log epoch (after a successful snapshot and merge)."""
    with open(path, "wb") as f:
        f.write(_HDR.pack(MAGIC, dim, start_seqno))
