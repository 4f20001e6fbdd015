"""The serving slice against the reference: the row-sharded LTI lane
(``shard_lti``), the sequential per-tier oracle (``batch_fanout=False``),
the beam-width autotuner, ``ReplicaSet`` and ``BatchScheduler``.

Both packages start from the reference's bootstrap LTI (integer
coordinates, carried across with ``repro_torch.convert``) and take the same
stream: inserts through two RW -> RO rollovers, deletes in every tier.
Everything is compared bit for bit: ids, distances, the lane counters
(hops, cmps), the autotuner's sweep and its W, dispatch counts, and every
scheduler decision on a ``VirtualClock`` (batch sizes, close times,
sheds, misses, latencies, the EWMA estimate), filtered traffic included:
per-spec batches, tenant quotas and their sheds, ``ReplicaSet`` under a
``FilterSpec`` on labelled systems.  On the CPU a shard group of
n is the host n times: the port runs every shard's owner share, while the
reference, on one host device, serves unsharded; the sharded lane must
equal it.  The 4-device reference runs in ``tests/test_torch_distributed.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import autotune as jautotune  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import system as jsystem  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import system as tsystem  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import ReplicaSet  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

N0, D, NQ = 256, 16, 37


def _cfg(mod, **kw):
    base = dict(
        index=mod.IndexConfig(capacity=320, dim=D, R=8, L_build=16,
                              L_search=24, alpha=1.2, beam_width=4),
        pq=mod.PQConfig(dim=D, m=4, ksub=16, kmeans_iters=3),
        ro_snapshot_points=48, merge_threshold=100_000, temp_capacity=96,
        insert_batch=16, batch_queries=16)
    base.update(kw)
    return mod.SystemConfig(**base)


def _stream(sys_, new):
    """Two rollovers at 48 points, deletes in the LTI, RO and RW tiers."""
    for i in range(120):
        sys_.insert(1000 + i, new[i])
    for e in (3, 17, 1005, 1050, 1100, 1119):
        sys_.delete(e)


@pytest.fixture(scope="module")
def world():
    g = np.random.default_rng(11)
    x = g.integers(-3, 4, (N0 + 140 + NQ, D)).astype(np.float32)
    base, new, qs = x[:N0], x[N0:N0 + 140], x[N0 + 140:]
    boot = jsystem.bootstrap_system(base, np.arange(N0), _cfg(jconfig),
                                    batch=32)

    def ref(stream=True, **kw):
        s = jsystem.FreshDiskANN(_cfg(jconfig, **kw), lti=boot.lti,
                                 lti_ext_ids=boot.lti_ext_ids.copy())
        if stream:
            _stream(s, new)
        return s

    def port(stream=True, **kw):
        lti = boot.lti
        s = tsystem.FreshDiskANN(
            _cfg(tconfig, **kw),
            lti=convert.lti_state(lti.graph, lti.codes,
                                  lti.codebook.centroids, "cpu"),
            lti_ext_ids=convert.ext_table(boot.lti_ext_ids), device="cpu")
        if stream:
            _stream(s, new)
        return s

    return dict(ref=ref, port=port, new=new, qs=qs)


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _lane_counters(sys_, q, unified, **extra):
    """(ids, dists, hops, cmps) of one micro-batch through ``unified`` on
    the system's own lane bundle and drop masks."""
    rw_t, ro_temps, lti_entry = sys_._capture_lanes()
    bundle = sys_._lane_bundle(rw_t, ro_temps, lti_entry)
    key, stack, t_tabs, l_tab, tables_np = bundle[:5]
    t_drop, l_drop = sys_._drop_mask(key, tables_np)
    return unified(stack, t_tabs, l_tab, t_drop, l_drop, q, **extra)


# ------------------------------------------------------- sharded LTI lane

@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_lti_matches_unsharded_reference(world, n_shards):
    """search_batch over a CPU group of 1/2/4 shards equals the
    reference's unsharded search_batch, and the sharded step's hops and
    cmps equal its unified program's, one dispatch per micro-batch."""
    ref, port = world["ref"](), world["port"](shard_lti=n_shards)
    assert port.lti_shards == n_shards
    qs = world["qs"]
    d0 = port.stats.search_dispatches
    _same(port.search_batch(qs, k=5), ref.search_batch(qs, k=5))
    assert port.stats.search_dispatches - d0 == 3       # 16 + 16 + 5

    def ref_unified(stack, t_tabs, l_tab, t_drop, l_drop, q):
        return jindex.unified_search(
            stack, t_tabs, l_tab, t_drop, l_drop, jnp.asarray(q),
            ref.cfg.index, k=5, k_lane=13, L=24, beam_width=4, rerank=True)

    def port_sharded(stack, t_tabs, l_tab, t_drop, l_drop, q):
        step, sstack = port._sharded_program(stack, k=5, kk=13, L=24, W=4,
                                             rerank=True)
        assert len(sstack.lti) == n_shards
        return step(sstack, t_tabs, l_tab, t_drop, l_drop,
                    torch.from_numpy(q))

    want = _lane_counters(ref, qs, ref_unified)
    got = _lane_counters(port, qs, port_sharded)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n_shards", [1, 4])
def test_shard_lti_through_merge(world, n_shards):
    """A merge swaps the LTI: the placement cache misses and the new
    generation is re-sharded, still equal to the reference."""
    ref, port = world["ref"](), world["port"](shard_lti=n_shards)
    qs = world["qs"]
    for s in (ref, port):
        s.search_batch(qs[:4], k=5)          # warm the sharded placement
        s.delete(1001)
        s.merge()
    assert port._shard_place is None
    _same(port.search_batch(qs, k=5), ref.search_batch(qs, k=5))
    assert port._shard_place[0] is port.lti.graph


def test_census_caps_only_on_cuda(world):
    """On the CPU every shard is the host: a group of 64 is not capped
    (the reference caps at its device census and serves the same rows)."""
    port = world["port"](shard_lti=64)
    assert port.lti_shards == 64
    _same(port.search_batch(world["qs"][:5], k=3),
          world["ref"]().search_batch(world["qs"][:5], k=3))


# ------------------------------------------------------ sequential oracle

@pytest.mark.parametrize("bq", [0, 16])
def test_sequential_oracle_matches_reference(world, bq):
    """batch_fanout=False: one search per tier per micro-batch and the host
    aggregation, equal to the reference's oracle and to the unified path,
    with the reference's dispatch count (LTI + RW + 2 RO per chunk)."""
    ref = world["ref"](batch_fanout=False, batch_queries=bq)
    port = world["port"](batch_fanout=False, batch_queries=bq)
    unified = world["port"](batch_queries=bq)
    qs = world["qs"]
    want = ref.search_batch(qs, k=5)
    _same(port.search_batch(qs, k=5), want)
    _same(unified.search_batch(qs, k=5), want)
    assert port.stats.search_dispatches == ref.stats.search_dispatches \
        == 4 * (3 if bq else 1)


# --------------------------------------------------------------- autotune

@pytest.mark.parametrize("fanout", [True, False])
def test_autotune_matches_reference(world, fanout, monkeypatch):
    """The autotuner's sweep (W, mean hops, mean cmps per candidate) and
    its pick equal the reference's; a merge clears the cached W in both,
    and the next search re-calibrates it."""
    swept = []

    def spy(fn, widths):
        swept.append(orig(fn, widths))
        return swept[-1]

    orig = jautotune.measure_widths
    monkeypatch.setattr(jautotune, "measure_widths", spy)
    ref = world["ref"](autotune_beam=True, batch_fanout=fanout)
    port = world["port"](autotune_beam=True, batch_fanout=fanout)
    qs = world["qs"]
    _same(port.search_batch(qs, k=5), ref.search_batch(qs, k=5))
    points = port._beam_sweep(qs)
    want = [(p.W, p.hops, p.cmps) for p in swept[0]]
    assert [(p.W, p.hops, p.cmps) for p in points] == want
    assert port._tuned_w == ref._tuned_w
    for s in (ref, port):
        s.merge()
        assert s._tuned_w is None
    _same(port.search_batch(qs, k=5), ref.search_batch(qs, k=5))
    assert port._tuned_w == ref._tuned_w


def test_autotune_waits_for_a_representative_tier(world):
    """With no tier of L points the static W serves and nothing is
    cached, as in the reference."""
    port = world["port"](stream=False, autotune_beam=True)
    port._lti_pair = (port.lti._replace(graph=port.lti.graph._replace(
        n_total=torch.zeros((), dtype=torch.int32))), port.lti_ext_ids,
        port.lti_labels)
    assert port._beam_width(world["qs"]) == port.cfg.index.beam_width
    assert port._tuned_w is None


# ---------------------------------------------------------------- replicas

@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_replica_set_matches_search_batch(world, n_rep):
    """Round-robin over 1/2/4 CPU replicas: the rows of search_batch, one
    dispatch per micro-batch on the next replica, pinned routing and its
    range check; the system's counters equal the reference's after the
    same routed run."""
    port = world["port"]()
    ref = world["ref"]()
    qs = world["qs"]
    want = port.search_batch(qs, k=5)
    rs = ReplicaSet(port, n_rep)
    assert rs.n_replicas == n_rep and rs.n_shards == 1
    s0 = dataclasses.replace(port.stats)
    _same(rs.search_batch(qs, k=5), want)          # 16 + 16 + 5: 3 chunks
    expect = [0] * n_rep
    for c in range(3):
        expect[c % n_rep] += 1
    assert rs.dispatches == expect
    assert port.stats.search_dispatches - s0.search_dispatches == 3
    assert port.stats.searches - s0.searches == NQ
    _same(rs.search_batch(qs[:3], k=5, replica=n_rep - 1), (want[0][:3],
                                                            want[1][:3]))
    assert rs.dispatches[n_rep - 1] == expect[n_rep - 1] + 1
    with pytest.raises(ValueError):
        rs.search_batch(qs[:2], k=5, replica=n_rep)
    from repro.serving import ReplicaSet as JReplicaSet
    ref.search_batch(qs, k=5)
    jrs = JReplicaSet(ref, 1)
    _same(jrs.search_batch(qs, k=5), want)
    jrs.search_batch(qs[:3], k=5, replica=0)
    with pytest.raises(ValueError):
        jrs.search_batch(qs[:2], k=5, replica=1)
    for f in ("searches", "search_dispatches"):
        assert getattr(port.stats, f) == getattr(ref.stats, f)
    assert port.stats.search_latency.seen == ref.stats.search_latency.seen


def test_replica_set_with_shards(world):
    """A 2 x 2 grid: each replica runs the sharded lane on its group."""
    port = world["port"](shard_lti=2)
    rs = ReplicaSet(port, 2)
    assert (rs.n_replicas, rs.n_shards) == (2, 2)
    _same(rs.search_batch(world["qs"], k=5),
          world["ref"]().search_batch(world["qs"], k=5))
    assert all(len(p[2]) == 2 for p in rs._place)


def test_replica_routing_survives_background_merge(world):
    """A background merge swaps the LTI mid-service: the replica's
    placement misses on its next dispatch and places the new graph, equal
    to a reference system merged in the foreground."""
    ref = world["ref"]()
    port = world["port"](background_merge=True)
    rs = ReplicaSet(port, 1)
    qs = world["qs"]
    rs.search_batch(qs[:4], k=5)                 # warm the placement cache
    for s in (ref, port):
        s.delete(1001)
    ref.merge()
    port.merge(background=True)
    port.wait_merge()
    assert port.stats.merges == 1
    _same(rs.search_batch(qs, k=5), ref.search_batch(qs, k=5))
    assert rs._place[0][0] is port.lti.graph


def test_scheduler_worker_beside_background_merge(world):
    """A wall-clock worker thread serves tickets through a ReplicaSet while
    a background merge runs: every ticket completes, none returns an id
    the merge consolidated away, and after the merge the tickets equal the
    reference's search on the merged system."""
    ref = world["ref"]()
    port = world["port"](background_merge=True, slo_ms=5.0)
    qs = world["qs"]
    sched = tsched.BatchScheduler(port, k=5, serve=ReplicaSet(port, 2)
                                  .search_batch)
    sched.start()
    try:
        before = [sched.submit(q) for q in qs[:8]]
        for t in before:
            t.result(timeout=60.0)
        for s in (ref, port):
            s.delete(1001)
        ref.merge()
        port.merge(background=True)
        during = [sched.submit(q) for q in qs]
        port.wait_merge()
        for t in during:
            ids, _ = t.result(timeout=60.0)
            assert 1001 not in ids.tolist()
        after = [sched.submit(q) for q in qs]
        want_ids, want_d = ref.search_batch(qs, k=5)
        for i, t in enumerate(after):
            ids, d = t.result(timeout=60.0)
            np.testing.assert_array_equal(ids, want_ids[i])
            np.testing.assert_array_equal(d, want_d[i])
    finally:
        sched.stop()
    assert port.stats.merges == 1
    assert port.stats.scheduled_requests == 8 + 2 * NQ


# --------------------------------------------------------------- scheduler

def _advance(clk, sched, dt):
    """The reference suite's driver: advance the clock by ``dt``, stopping
    at every close time to run the scheduler."""
    target = clk.now() + dt
    while True:
        nct = sched.next_close_time()
        if nct is None or nct > target:
            break
        if nct > clk.now():
            clk.advance(nct - clk.now())
        if sched.run_once() == 0:
            break
    if target > clk.now():
        clk.advance(target - clk.now())


def _pump(sched):
    while sched.run_once():
        pass


def _trace(name, sched, clk, qs, log):
    """The deterministic traces of ``tests/test_scheduler.py``."""
    tickets = []
    if name == "full_then_deadline":
        for q in qs[:19]:
            tickets.append(sched.submit(q))
            _pump(sched)
        log.append(("close_at", sched.next_close_time()))
        _advance(clk, sched, 1.0)
    elif name == "deadline_bounds_wait":
        for q in qs[:7]:
            tickets.append(sched.submit(q))
            _advance(clk, sched, 0.003)
        _advance(clk, sched, 0.050)
    elif name == "no_slo":
        tickets = [sched.submit(q) for q in qs[:5]]
        log.append(("close_at", sched.next_close_time()))
        clk.advance(1e6)
        log.append(("run_once", sched.run_once(), sched.pending))
        log.append(("flush", sched.flush()))
    elif name == "miss":
        tickets.append(sched.submit(qs[0]))
        clk.advance(0.100)
        log.append(("run_once", sched.run_once()))
    elif name == "ewma":
        tickets = [sched.submit(q) for q in qs[:16]]
        _pump(sched)
    elif name == "ragged":
        rng = np.random.default_rng(3)
        qi = 0
        while qi < len(qs):
            for _ in range(min(int(rng.integers(0, 4)), len(qs) - qi)):
                tickets.append(sched.submit(qs[qi]))
                qi += 1
                _pump(sched)
            _advance(clk, sched, float(rng.integers(0, 30)) / 1e3)
        _advance(clk, sched, 1.0)
        log.append(("flush", sched.flush()))
    elif name == "backpressure":
        tickets = [sched.submit(q) for q in qs[:10]]
        log.append(("flush", sched.flush()))
        tickets.append(sched.submit(qs[0]))
        log.append(("flush", sched.flush()))
    return tickets


_TRACES = {   # name -> (slo_ms, batch_queries, capacity, dispatch estimate)
    "full_then_deadline": (50.0, 8, 1024, 5.0),
    "deadline_bounds_wait": (20.0, 8, 1024, 5.0),
    "no_slo": (0.0, 8, 1024, 5.0),
    "miss": (10.0, 8, 1024, 5.0),
    "ewma": (50.0, 8, 1024, 10.0),
    "ragged": (50.0, 4, 1024, 5.0),
    "backpressure": (0.0, 8, 6, 5.0),
}


def _run_scheduler(make, sched_mod, name, qs):
    slo, bq, cap, est = _TRACES[name]
    clk = sched_mod.VirtualClock()
    sys_ = make(batch_queries=bq, slo_ms=slo, serve_queue_capacity=cap,
                dispatch_estimate_ms=est, clock=clk)
    log = []
    direct = sys_.search_batch

    def serve(q, k, L=None, beam_width=None):
        log.append(("dispatch", clk.now(), len(q)))
        return direct(q, k, L=L, beam_width=beam_width)

    sched = sched_mod.BatchScheduler(sys_, k=5, serve=serve)
    assert sched.clock is clk
    tickets = _trace(name, sched, clk, qs, log)
    st = sys_.stats
    out = dict(log=log, estimate=sched.dispatch_estimate,
               occupancy=sched.mean_occupancy, pending=sched.pending,
               stats=[st.scheduled_requests, st.shed_requests,
                      st.batches_dispatched, st.deadline_misses,
                      st.queue_depth, st.batch_occupancy],
               latency=list(st.serve_latency.sample), tickets=[])
    for t in tickets:
        out["tickets"].append(None if t is None else (
            t.arrival, t.deadline, t.completion, t.missed, t.done.is_set(),
            None if t.ids is None else (t.ids.tolist(), t.dists.tolist())))
    return out


@pytest.mark.parametrize("name", list(_TRACES))
def test_scheduler_traces_match_reference(world, name):
    """On a VirtualClock both schedulers make the same decisions on the
    reference suite's traces: the same batches at the same clock times,
    close times, sheds, misses, latencies, EWMA estimate, occupancy and
    stats, and every ticket's row equal to the reference's."""
    want = _run_scheduler(world["ref"], jsched, name, world["qs"])
    got = _run_scheduler(world["port"], tsched, name, world["qs"])
    assert got == want
    assert any(e[0] == "dispatch" for e in got["log"])


def _labelled(make, mod, new, **kw):
    """A system of ``make`` with labels: LTI slot i carries label i % 3
    and tenant i % 4, the stream's inserts likewise, and the deletes of
    ``_stream``."""
    s = make(stream=False, filter_words=1, **kw)
    lb = mod.LabelTable(s.cfg.index.capacity, 1)
    for i in range(N0):
        lb.set_row(i, mod.pack_labels([i % 3], 1), i % 4)
    s.lti_labels = lb
    for i in range(120):
        s.insert(1000 + i, new[i], labels=[i % 3], tenant=i % 4)
    for e in (3, 17, 1005, 1050, 1100, 1119):
        s.delete(e)
    return s


_FSPECS = (dict(tenant=1), dict(all_of=(2,)), dict(all_of=(0,), tenant=3))


@pytest.mark.parametrize("n_rep", [1, 2])
def test_replica_set_filtered_matches_reference(world, n_rep):
    """``ReplicaSet.search_batch(filter=)``: the system's filtered rows (the
    filtered masks on the replica program), the reference's, and the
    reference's filtered and per-tenant accounting."""
    from repro.core import graph as jgraph
    from repro.serving import ReplicaSet as JReplicaSet
    from repro_torch.core import graph as tgraph
    port = _labelled(world["port"], tgraph, world["new"])
    ref = _labelled(world["ref"], jgraph, world["new"])
    qs = world["qs"]
    rs, jrs = ReplicaSet(port, n_rep), JReplicaSet(ref, 1)
    for kw in _FSPECS:
        want = port.search_batch(qs, k=5, filter=tgraph.FilterSpec(**kw))
        _same(rs.search_batch(qs, k=5, filter=tgraph.FilterSpec(**kw)),
              want)
        _same(jrs.search_batch(qs, k=5, filter=jgraph.FilterSpec(**kw)),
              want)
        _same(ref.search_batch(qs, k=5, filter=jgraph.FilterSpec(**kw)),
              want)
    _same(rs.search_batch(qs[:3], k=5, filter=tgraph.FilterSpec()),
          port.search_batch(qs[:3], k=5))
    jrs.search_batch(qs[:3], k=5, filter=jgraph.FilterSpec())
    ref.search_batch(qs[:3], k=5)
    for f in ("searches", "filtered_searches", "tenant_searches",
              "search_dispatches"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    assert port.stats.tenant_searches == {1: 2 * NQ, 3: 2 * NQ}
    assert sum(rs.dispatches) == 3 * 3 + 1


def _spec_key(spec):
    return None if spec is None else (spec.all_of, spec.any_of, spec.tenant)


_FTRACES = {  # name -> (slo_ms, batch_queries, capacity, tenant_quota)
    "mixed_specs": (50.0, 4, 1024, 0),
    "tenant_quota": (0.0, 4, 1024, 2),
    "quota_and_capacity": (20.0, 4, 7, 3),
}


def _run_filtered_scheduler(make, sched_mod, graph_mod, name, qs, new):
    """One filtered trace on a labelled system on a VirtualClock: the
    dispatches (clock, size, spec), close times, sheds per tenant, stats
    and every ticket's outcome."""
    slo, bq, cap, quota = _FTRACES[name]
    clk = sched_mod.VirtualClock()
    sys_ = _labelled(make, graph_mod, new, batch_queries=bq, slo_ms=slo,
                     serve_queue_capacity=cap, dispatch_estimate_ms=5.0,
                     clock=clk, tenant_quota=quota)
    log = []
    direct = sys_.search_batch

    def serve(q, k, L=None, beam_width=None, **kw):
        log.append(("dispatch", clk.now(), len(q),
                    _spec_key(kw.get("filter"))))
        return direct(q, k, L=L, beam_width=beam_width, **kw)

    FS = graph_mod.FilterSpec
    specs = [None, FS(tenant=0), FS(tenant=1), FS(all_of=(1,)), None,
             FS(tenant=1), FS(all_of=(1,)), FS()]
    sched = sched_mod.BatchScheduler(sys_, k=5, serve=serve)
    tickets = []
    if name == "mixed_specs":
        for i, q in enumerate(qs[:23]):
            tickets.append(sched.submit(q, filter=specs[i % len(specs)]))
            _pump(sched)
            if i % 5 == 4:
                _advance(clk, sched, 0.011)
        log.append(("close_at", sched.next_close_time()))
        _advance(clk, sched, 1.0)
    elif name == "tenant_quota":
        for i in range(6):                    # a burst above the quota
            tickets.append(sched.submit(qs[i], filter=FS(tenant=1)))
        for i in range(3):
            tickets.append(sched.submit(qs[6 + i], filter=FS(tenant=2)))
        tickets.append(sched.submit(qs[9]))
        log.append(("pending", sched.pending))
        log.append(("flush", sched.flush()))
        tickets.append(sched.submit(qs[10], filter=FS(tenant=1)))
        log.append(("flush", sched.flush()))
    else:
        for i, q in enumerate(qs[:20]):
            tickets.append(sched.submit(q, filter=specs[i % 3]))
            if i % 4 == 3:
                _advance(clk, sched, 0.007)
        _advance(clk, sched, 1.0)
        log.append(("flush", sched.flush()))
    st = sys_.stats
    out = dict(log=log, pending=sched.pending,
               stats=[st.scheduled_requests, st.shed_requests,
                      st.batches_dispatched, st.deadline_misses,
                      st.queue_depth, st.filtered_searches],
               tenant_sheds=dict(st.tenant_sheds),
               tenant_searches=dict(st.tenant_searches),
               latency=list(st.serve_latency.sample), tickets=[])
    for t in tickets:
        out["tickets"].append(None if t is None else (
            t.arrival, t.deadline, t.completion, t.missed, _spec_key(
                t.fspec), t.ids.tolist(), t.dists.tolist()))
    # Each served row is search_batch's for its query under its spec.
    out["rows_equal_direct"] = all(
        np.array_equal(np.stack([t.ids, t.dists]), np.stack(
            [x[0] for x in direct(t.query[None], 5, filter=t.fspec)]))
        for t in tickets if t is not None)
    return out


@pytest.mark.parametrize("name", list(_FTRACES))
def test_scheduler_filtered_traces_match_reference(world, name):
    """Per-spec batching and tenant quotas on a VirtualClock: a batch holds
    only the oldest ticket's spec, other tickets keep their places, a
    tenant past its quota is shed and counted by tenant and in
    ``shed_requests``; every decision, stat and ticket row equals the
    reference's, and each ticket's row equals ``search_batch`` under its
    spec."""
    from repro.core import graph as jgraph
    from repro_torch.core import graph as tgraph
    args = (world["qs"], world["new"])
    want = _run_filtered_scheduler(world["ref"], jsched, jgraph, name, *args)
    got = _run_filtered_scheduler(world["port"], tsched, tgraph, name, *args)
    assert got == want
    specs = {e[3] for e in got["log"] if e[0] == "dispatch"}
    assert len(specs) >= 2
    if name != "mixed_specs":
        assert sum(got["tenant_sheds"].values()) > 0
        assert got["stats"][1] >= sum(got["tenant_sheds"].values())
    if name == "tenant_quota":
        assert got["tenant_sheds"] == {1: 4, 2: 1}
    assert got["rows_equal_direct"]


def test_cpu_serving_never_reaches_a_kernel(world):
    ops.reset_launches()
    port = world["port"](shard_lti=2)
    ReplicaSet(port, 2).search_batch(world["qs"][:5], k=5)
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}
