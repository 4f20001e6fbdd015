"""Continuous-batching serving front end: the PyTorch port of
``serving/scheduler.py`` (numpy and threads only; the port keeps its own
copy).

A bounded request queue and a deadline-aware scheduler pack ragged live
arrivals into the fixed-shape micro-batches ``search_batch`` serves.  A
batch closes when it fills to ``batch_queries`` or when the oldest queued
request's deadline (``SystemConfig.slo_ms`` after its arrival, less an
EWMA estimate of the dispatch time) would otherwise be missed, whichever
comes first.  The batch is ONE ``search_batch`` call (or ``ReplicaSet``'s),
so every request's row is the one a direct ``search_batch`` returns.

Every policy decision (admit or shed, close or wait, miss or meet) reads
only the injected ``Clock`` (``SystemConfig.clock``), never the wall: the
synchronous core (``submit``, ``poll``, ``dispatch``, ``next_close_time``)
driven by a ``VirtualClock`` replays deterministically, and ``start()``
runs the same core on a worker thread against the wall clock, beside
background merges (which swap whole LTI generations under the system's
locks; a search never waits for one).

Submissions past ``SystemConfig.serve_queue_capacity`` are shed:
``submit`` returns None and ``SystemStats.shed_requests`` counts them.

Filtered and multi-tenant traffic rides the same queue: ``submit`` takes an
optional ``FilterSpec``, and a closed micro-batch holds only tickets that
share the oldest queued ticket's spec (the filter is an argument of the one
``search_batch`` call); tickets of other specs keep their places, and each
spec keeps its FIFO order.  With ``SystemConfig.tenant_quota`` > 0 a
tenant holds at most that many queued tickets; its further submissions are
shed (``submit`` returns None), counted in ``SystemStats.tenant_sheds`` by
tenant and in ``shed_requests``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Clock(Protocol):
    """What the scheduler needs from time: a monotonic ``now()``."""

    def now(self) -> float:
        ...


class WallClock:
    """Production clock: ``time.monotonic`` seconds."""

    def now(self) -> float:
        return time.monotonic()


class VirtualClock:
    """A manually-advanced clock: ``now()`` returns exactly what the test
    set, so every scheduler decision derived from it is deterministic.
    Picklable (it rides inside ``SystemConfig``)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError(f"VirtualClock.advance({seconds}): time only "
                             f"moves forward")
        self._t += float(seconds)
        return self._t


class Ticket:
    """One in-flight request: the caller's handle to its (ids, dists) row.

    ``result()`` blocks (wall-clock deployments); under a virtual clock the
    test drives the scheduler itself, so ``done`` is already set when it
    reads the fields.  ``latency`` is completion - arrival on the
    scheduler's clock; ``missed`` is the deadline verdict recorded at
    completion; ``fspec`` is the request's filter (None: unfiltered)."""

    __slots__ = ("query", "arrival", "deadline", "fspec", "ids", "dists",
                 "completion", "missed", "done")

    def __init__(self, query: np.ndarray, arrival: float, deadline: float,
                 fspec=None):
        self.query = query
        self.arrival = arrival
        self.deadline = deadline
        self.fspec = fspec
        self.ids: Optional[np.ndarray] = None
        self.dists: Optional[np.ndarray] = None
        self.completion: Optional[float] = None
        self.missed = False
        self.done = threading.Event()

    @property
    def latency(self) -> Optional[float]:
        if self.completion is None:
            return None
        return self.completion - self.arrival

    def result(self, timeout: Optional[float] = None
               ) -> tuple[np.ndarray, np.ndarray]:
        if not self.done.wait(timeout):
            raise TimeoutError("request not served within timeout")
        return self.ids, self.dists


class BatchScheduler:
    """The deadline-aware continuous-batching scheduler.

    Policy (all against ``clock.now()``):

      * ``submit(query, filter=)`` — admit to the FIFO queue, or SHED
        (return None) when the queue is at ``cfg.serve_queue_capacity`` or
        the ticket's tenant holds ``cfg.tenant_quota`` queued tickets.
      * ``poll()`` — close a micro-batch when (a) the queue holds
        ``cfg.batch_queries`` requests (full close), or (b) ``cfg.slo_ms``
        is set and ``now + dispatch_estimate`` has reached the OLDEST
        request's deadline (deadline close: waiting any longer would blow
        its budget).  An empty queue never closes a batch.
      * ``dispatch(batch)`` — one ``serve`` call on the stacked queries
        (default ``system.search_batch``; ``ReplicaSet.search_batch``
        plugs in here for multi-replica serving), rows de-interleaved back to the
        tickets in arrival order, per-request latency recorded into
        ``stats.serve_latency`` and late completions into
        ``stats.deadline_misses``.

    The dispatch estimate is an EWMA of measured dispatch wall time on the
    scheduler's clock, seeded by ``cfg.dispatch_estimate_ms``; under a
    virtual clock the measurement is whatever the test advances (usually
    0), so the estimate — and hence every close decision — stays
    deterministic.

    ``run_once``/``flush`` drive the core synchronously; ``start``/``stop``
    run it on a worker thread (wall-clock deployments only — a virtual
    clock never moves on its own, so the thread would sleep forever).
    """

    def __init__(self, system, k: int, *, L: Optional[int] = None,
                 beam_width: Optional[int] = None,
                 serve: Optional[Callable] = None,
                 clock: Optional[Clock] = None):
        cfg = system.cfg
        if cfg.batch_queries <= 0:
            raise ValueError(
                "BatchScheduler needs SystemConfig.batch_queries > 0 — the "
                "micro-batch width is the shape batches are packed to")
        self.system = system
        self.stats = system.stats
        self.k = k
        self.L = L
        self.beam_width = beam_width
        self.batch_queries = cfg.batch_queries
        self.capacity = cfg.serve_queue_capacity
        self.slo = cfg.slo_ms / 1e3 if cfg.slo_ms > 0 else None
        self.tenant_quota = max(cfg.tenant_quota, 0)
        self._queued_by_tenant: dict = {}
        self.clock: Clock = clock or cfg.clock or WallClock()
        self.dispatch_estimate = max(cfg.dispatch_estimate_ms, 0.0) / 1e3
        self._serve = serve or system.search_batch
        self._queue: deque[Ticket] = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # Occupancy accounting beyond the last-batch gauge: mean fill over
        # the scheduler's lifetime (benchmarks report it per run).
        self._occupancy_sum = 0.0
        self._batches = 0

    # ------------------------------------------------------------- requests
    def submit(self, query: np.ndarray, filter=None) -> Optional[Ticket]:
        """Admit one query (shape [dim]), or shed it: returns the caller's
        ``Ticket``, or None when the bounded queue is full or the ticket's
        tenant already holds ``cfg.tenant_quota`` queued tickets (counted in
        ``shed_requests``, a quota shed also in ``tenant_sheds[tenant]``;
        never dropped silently).  ``filter`` is an optional ``FilterSpec``
        applied to the micro-batch that serves the ticket."""
        q = np.asarray(query, np.float32)
        fspec = filter if filter is not None and not filter.is_empty \
            else None
        tenant = fspec.tenant if fspec is not None else None
        with self._cond:
            if len(self._queue) >= self.capacity:
                self.stats.shed_requests += 1
                return None
            if (self.tenant_quota and tenant is not None
                    and self._queued_by_tenant.get(tenant, 0)
                    >= self.tenant_quota):
                self.stats.shed_requests += 1
                self.stats.tenant_sheds[tenant] = (
                    self.stats.tenant_sheds.get(tenant, 0) + 1)
                return None
            now = self.clock.now()
            deadline = now + self.slo if self.slo is not None else np.inf
            t = Ticket(q, now, deadline, fspec)
            if tenant is not None:
                self._queued_by_tenant[tenant] = (
                    self._queued_by_tenant.get(tenant, 0) + 1)
            self._queue.append(t)
            self.stats.scheduled_requests += 1
            self.stats.queue_depth = len(self._queue)
            self._cond.notify()
        return t

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def mean_occupancy(self) -> float:
        """Lifetime mean fill fraction of dispatched micro-batches."""
        if self._batches == 0:
            return 0.0
        return self._occupancy_sum / self._batches

    # --------------------------------------------------------------- policy
    def next_close_time(self) -> Optional[float]:
        """The clock time at which the current queue must close: now when
        already full, the oldest deadline minus the dispatch estimate under
        an SLO, None when empty (or when no SLO bounds a partial batch —
        it then closes only on fill or ``flush``).  The worker thread (and
        a deterministic test driver) sleeps exactly until this."""
        with self._lock:
            return self._next_close_locked()

    def _next_close_locked(self) -> Optional[float]:
        if not self._queue:
            return None
        if len(self._queue) >= self.batch_queries:
            return self.clock.now()
        if self.slo is None:
            return None
        return self._queue[0].deadline - self.dispatch_estimate

    def poll(self) -> Optional[list[Ticket]]:
        """Close a micro-batch if policy says so at ``clock.now()``; the
        caller dispatches it.  Returns None when no close is due."""
        with self._lock:
            close_at = self._next_close_locked()
            if close_at is None or self.clock.now() < close_at:
                return None
            return self._take_locked()

    def _take_locked(self) -> list[Ticket]:
        """Pop the next micro-batch: up to ``batch_queries`` tickets that
        share the oldest queued ticket's spec, in FIFO order; tickets of
        other specs keep their places in the queue."""
        if not self._queue:
            return []
        spec = self._queue[0].fspec
        batch: list[Ticket] = []
        rest: list[Ticket] = []
        while self._queue and len(batch) < self.batch_queries:
            t = self._queue.popleft()
            (batch if t.fspec == spec else rest).append(t)
        self._queue.extendleft(reversed(rest))
        for t in batch:
            if t.fspec is not None and t.fspec.tenant is not None:
                left = self._queued_by_tenant.get(t.fspec.tenant, 0) - 1
                if left > 0:
                    self._queued_by_tenant[t.fspec.tenant] = left
                else:
                    self._queued_by_tenant.pop(t.fspec.tenant, None)
        self.stats.queue_depth = len(self._queue)
        return batch

    # ------------------------------------------------------------- dispatch
    def dispatch(self, batch: list[Ticket]) -> None:
        """Serve one closed micro-batch and de-interleave the rows back.

        The batch rides ONE ``serve`` call on the stacked queries — with
        ``batch_queries`` set on the system, a partial batch is zero-padded
        by ``search_batch`` itself, so scheduled results are bit-identical
        to the caller invoking ``search_batch`` directly (per-query
        bit-parity is the engine's contract; this layer only stacks and
        slices rows in arrival order)."""
        if not batch:
            return
        qs = np.stack([t.query for t in batch])
        t0 = self.clock.now()
        # The filter rides only when set, so a label-free serve callable
        # keeps its signature.
        kw = {} if batch[0].fspec is None else {"filter": batch[0].fspec}
        ids, dists = self._serve(qs, self.k, L=self.L,
                                 beam_width=self.beam_width, **kw)
        t1 = self.clock.now()
        # EWMA toward the measured dispatch; on a virtual clock the
        # measurement is the test's advance (0 unless it models compute),
        # so the estimate trajectory is deterministic too.
        self.dispatch_estimate = (0.8 * self.dispatch_estimate
                                  + 0.2 * (t1 - t0))
        occupancy = len(batch) / self.batch_queries
        self.stats.batches_dispatched += 1
        self.stats.batch_occupancy = occupancy
        self._occupancy_sum += occupancy
        self._batches += 1
        for i, t in enumerate(batch):
            t.ids, t.dists = ids[i], dists[i]
            t.completion = t1
            self.stats.serve_latency.record(t1 - t.arrival)
            if t1 > t.deadline:
                t.missed = True
                self.stats.deadline_misses += 1
            t.done.set()

    def run_once(self) -> int:
        """One synchronous scheduler turn: poll, dispatch if a batch
        closed.  Returns the number of requests served (0 = nothing due).
        This is the deterministic drive path — tests advance the virtual
        clock and call this at the times ``next_close_time`` names."""
        batch = self.poll()
        if batch is None:
            return 0
        self.dispatch(batch)
        return len(batch)

    def flush(self) -> int:
        """Drain the queue unconditionally (shutdown path): close batches
        of at most ``batch_queries`` until empty, deadlines or not."""
        served = 0
        while True:
            with self._lock:
                batch = self._take_locked()
            if not batch:
                return served
            self.dispatch(batch)
            served += len(batch)

    # ------------------------------------------------------- threaded loop
    def start(self) -> None:
        """Run the loop on a worker thread (wall-clock only): wake on
        arrivals, sleep until ``next_close_time``, dispatch outside the
        lock so submissions never block on a device program."""
        if self._thread and self._thread.is_alive():
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, flush: bool = True) -> None:
        """Stop the worker; by default serve whatever is still queued."""
        self._running = False
        with self._cond:
            self._cond.notify_all()
        if self._thread:
            self._thread.join()
            self._thread = None
        if flush:
            self.flush()

    def _loop(self) -> None:
        while True:
            with self._cond:
                if not self._running:
                    return
                close_at = self._next_close_locked()
                now = self.clock.now()
                if close_at is None:
                    self._cond.wait(timeout=0.05)
                    continue
                if now < close_at:
                    # New arrivals can only move the close EARLIER (a full
                    # queue) — the notify wakes us to re-evaluate.
                    self._cond.wait(timeout=close_at - now)
                    continue
                batch = self._take_locked()
            self.dispatch(batch)       # outside the lock: submits proceed
