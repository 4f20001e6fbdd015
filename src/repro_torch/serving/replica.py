"""Multi-replica data-parallel serving: the PyTorch port of
``serving/replica.py``.

``ReplicaSet`` replicates the unified fan-out over the rows of a
``[replica, data]`` device grid (``distributed.sharding.replica_mesh``):
each row is one replica serving whole micro-batches, its columns the
replica's ``shard_lti`` row shards, on which the sharded program
(``serving.steps.make_sharded_unified_step``) runs unchanged.  A
replica's LTI blocks live on its group's devices; the temp lanes and the
beam state stay on the system's device.

Micro-batches are routed round-robin (or pinned with ``replica=``).  Every
replica serves from the system's own lane bundle (``_lane_bundle``: tier
states are replaced, never edited, by a flush, rollover or merge) and the
sharded lane equals the unsharded one, so results are those of
``system.search_batch`` for any replica count, under a ``filter=`` too
(the system's filtered drop masks ride the replica's program unchanged).
Each replica caches its placement keyed by the LTI graph's and codes'
identity: a merge swaps the LTI, the next dispatch misses and places the
new generation.

Fewer devices than ``replicas x shards`` degrade instead of raising:
shards cap at the CUDA device count, then replicas at ``count // shards``
(at least 1).  On the CPU every device is the host and nothing is capped
(``distributed.sharding``).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch


class ReplicaSet:
    """Round-robin router over N data-parallel serving replicas.

    ``search_batch`` mirrors ``system.search_batch`` (same signature, same
    micro-batch chunking, the same results), routing each fixed-shape
    micro-batch to the next replica; pass it to ``BatchScheduler`` as
    ``serve`` to put the scheduler in front of the replicas.
    ``dispatches[r]`` counts the micro-batches replica r served.
    """

    def __init__(self, system, n_replicas: int, *,
                 n_shards: Optional[int] = None, devices=None):
        from ..distributed.sharding import (census, replica_groups,
                                            replica_mesh)
        if n_replicas < 1:
            raise ValueError(f"ReplicaSet: n_replicas={n_replicas} must "
                             f"be >= 1")
        if n_shards is None:
            n_shards = max(1, system.cfg.shard_lti)
        n_shards = max(1, n_shards)
        ndev = (len(devices) if devices is not None
                else census(system.device))
        if ndev is None:                 # the CPU: every device the host
            self.n_shards, self.n_replicas = n_shards, n_replicas
        else:
            self.n_shards = min(n_shards, ndev)
            self.n_replicas = max(1, min(n_replicas, ndev // self.n_shards))
        self.system = system
        self.mesh = replica_mesh(self.n_replicas, self.n_shards,
                                 device=system.device, devices=devices)
        self.groups = replica_groups(self.mesh)
        self.dispatches = [0] * self.n_replicas
        self._rr = 0
        # Per replica, as system._sharded_program: the placement keyed by
        # LTI graph and codes identity, the step per (k, kk, L, W, rerank).
        self._place: list = [None] * self.n_replicas
        self._steps: list = [dict() for _ in range(self.n_replicas)]

    # ---------------------------------------------------------------- route
    def search_batch(self, queries: np.ndarray, k: int,
                     L: Optional[int] = None,
                     beam_width: Optional[int] = None,
                     replica: Optional[int] = None, filter=None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """``system.search_batch``'s contract (L, W and kk resolution,
        ``batch_queries`` chunking with a zero-padded tail, the ``filter``
        and its accounting, the same results), each micro-batch dispatched
        to a replica: round-robin, or ``replica=r``."""
        sys_ = self.system
        sys_._flush_inserts()
        fspec = sys_._resolve_filter(filter)
        L = L or sys_.cfg.index.L_search
        if k > L:
            raise ValueError(
                f"search(k={k}, L={L}): k must be <= L -- the candidate list "
                f"holds only L entries; raise L or lower k")
        W = beam_width or sys_._beam_width(queries)
        kk = min(max(k * 2, k + 8), L)
        q = np.asarray(queries, np.float32)
        B = q.shape[0]
        sys_._count_searches(B, fspec)
        if B == 0:
            return (np.zeros((0, k), np.int64),
                    np.zeros((0, k), np.float32))
        bq = sys_.cfg.batch_queries
        if not bq or B <= bq:
            return self._dispatch_sliced(q, bq, k, kk, L, W, replica, fspec)
        outs = [self._dispatch_sliced(q[lo:lo + bq], bq, k, kk, L, W,
                                      replica, fspec)
                for lo in range(0, B, bq)]
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))

    def _dispatch_sliced(self, chunk, bq, k, kk, L, W, replica, fspec):
        """Pad one chunk to the micro-batch width, dispatch, slice the pad
        rows off."""
        n = len(chunk)
        if bq and n < bq:
            qp = np.zeros((bq, chunk.shape[1]), np.float32)
            qp[:n] = chunk
            chunk = qp
        ids, d = self._dispatch(chunk, k, kk, L, W, replica, fspec)
        return ids[:n], d[:n]

    def _next_replica(self) -> int:
        r = self._rr
        self._rr = (self._rr + 1) % self.n_replicas
        return r

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, queries, k, kk, L, W, replica, fspec):
        """Serve ONE micro-batch on one replica's device group, as
        ``system._search_dispatch`` does (same lane capture, bundle, drop
        masks, filtered or not, and latency sample).  Without an LTI lane,
        or with ``batch_fanout=False``, the system's own dispatch serves
        it: the replica axis exists once an LTI generation is live."""
        sys_ = self.system
        r = replica if replica is not None else self._next_replica()
        if not 0 <= r < self.n_replicas:
            raise ValueError(f"replica={r} out of range "
                             f"[0, {self.n_replicas})")
        rw_t, ro_temps, lti_entry = sys_._capture_lanes()
        if rw_t is None and not ro_temps and lti_entry is None:
            return sys_._aggregate([], k, queries.shape[0])
        if not sys_.cfg.batch_fanout or lti_entry is None:
            self.dispatches[r] += 1     # routed, served on the system path
            return sys_._search_dispatch(queries, k, kk, L, W, fspec)
        bundle = sys_._lane_bundle(rw_t, ro_temps, lti_entry)
        t_drop, l_drop = sys_._masks(bundle, fspec)
        stack, t_tabs, l_tab = bundle[1:4]
        step, sstack = self._replica_program(
            r, stack, k=k, kk=kk, L=L, W=W, rerank=sys_.cfg.rerank)
        t0 = time.perf_counter()
        ids, d, _, _ = step(sstack, t_tabs, l_tab, t_drop, l_drop,
                            torch.as_tensor(queries).to(sys_.device))
        out = (ids.cpu().numpy().astype(np.int64),
               d.cpu().numpy().astype(np.float32))
        sys_.stats.search_latency.record(time.perf_counter() - t0)
        sys_.stats.search_dispatches += 1
        self.dispatches[r] += 1
        return out

    def _replica_program(self, r, stack, *, k, kk, L, W, rerank):
        """(step, stack with the LTI placed on replica ``r``'s group),
        cached as ``system._sharded_program`` caches them."""
        from ..core.graph import LaneStack, shard_lti
        from .steps import make_sharded_unified_step
        group = self.groups[r]
        place = self._place[r]
        if (place is None or place[0] is not stack.lti
                or place[1] is not stack.codes):
            sg, sc = shard_lti(stack.lti, stack.codes, self.n_shards,
                               devices=group)
            place = (stack.lti, stack.codes, sg, sc)
            self._place[r] = place
        key = (k, kk, L, W, rerank)
        step = self._steps[r].get(key)
        if step is None:
            step = make_sharded_unified_step(
                group, self.system.cfg.index, k=k, k_lane=kk, L=L,
                beam_width=W, rerank=rerank)
            self._steps[r][key] = step
        return step, LaneStack(stack.temps, place[2], place[3],
                               stack.codebook)
