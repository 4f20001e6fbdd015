"""StreamingMerge and the merging system in the port against the JAX package.

* ``robust_prune_sdc``: the plain version against the reference's Pallas
  kernel in interpret mode on the reference's operands, and the port's
  gather-fused CPU wrapper; ``sdc_lut``/``SDCPrune`` and the SDC Patch
  phase (``apply_back_edges_codes``).
* ``streaming_merge`` on both flavours (full precision on PQ-decoded
  vectors, and SDC) and both Delete-phase sweeps against the reference's
  ``use_kernel=False`` engine: the merged LTI (graph, codes) and every
  ``MergeStats`` field but ``n_prune_rows`` (the port counts the prune
  rows it launched, the reference its fixed-shape worst case).
* ``FreshDiskANN`` through a threshold merge, a background merge, a
  global repair and ``consolidate`` against the reference's system.
* The oracle sweeps of ``tests/test_streaming_property.py`` on the port.

Tolerances: integer fixtures (integer coordinates and PQ codebook: every
f32 sum is exact) are bit-identical.  Gaussian fixtures: at least 90 % of
the merged adjacency rows identical (a near tie of an alpha test flips a
row, and a changed row can steer later insert searches) and 5-recall@5
over the merged index within 0.01 of the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import config as jconfig  # noqa: E402
from repro.core import index as jmem  # noqa: E402
from repro.core import insert as jins  # noqa: E402
from repro.core import lti as jlti  # noqa: E402
from repro.core import merge as jmerge  # noqa: E402
from repro.core import pq as jpq  # noqa: E402
from repro.core import system as jsystem  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import index as tmem  # noqa: E402
from repro_torch.core import insert as tins  # noqa: E402
from repro_torch.core import merge as tmerge  # noqa: E402
from repro_torch.core import pq as tpq  # noqa: E402
from repro_torch.core import system as tsystem  # noqa: E402
from repro_torch.core.prune import SDCPrune  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CAP, D, R, M, KSUB, N0, NN = 448, 16, 8, 4, 16, 300, 90
KINDS = ["integer", "gaussian"]


def _icfg(mod, **kw):
    return mod.IndexConfig(capacity=CAP, dim=D, R=R, L_build=16,
                           L_search=24, alpha=1.2, **kw)


def _pq(mod):
    return mod.PQConfig(dim=D, m=M, ksub=KSUB, kmeans_iters=3)


def _points(kind, g, n):
    if kind == "integer":
        return g.integers(-3, 4, (n, D)).astype(np.float32)
    centers = np.random.default_rng(99).standard_normal((8, D)) * 3.0
    return (centers[g.integers(0, 8, n)]
            + g.standard_normal((n, D))).astype(np.float32)


def _codebook(kind, g, pts):
    if kind == "integer":
        return g.integers(-3, 4, (M, KSUB, D // M)).astype(np.float32)
    return np.array(jpq.train_pq(jnp.asarray(pts), _pq(jconfig)).centroids)


def _lti_pair(pts, cent, cfg_j):
    """The same LTI for both packages: the reference's graph, codes from
    the given codebook."""
    jg = jmem.build(pts, cfg_j, batch=32)
    cb = jpq.PQCodebook(jnp.asarray(cent))
    codes = np.zeros((cfg_j.capacity, M), np.uint8)
    codes[:len(pts)] = np.asarray(jpq.encode(cb, jnp.asarray(pts),
                                             _pq(jconfig)))
    return (jlti.LTIState(jg, jnp.asarray(codes), cb),
            convert.lti_state(jg, codes, cent, "cpu"))


@pytest.fixture(scope="module", params=KINDS)
def merge_setup(request):
    kind = request.param
    g = np.random.default_rng(3)
    pts = _points(kind, g, N0 + NN + 24)
    cent = _codebook(kind, g, pts[:N0])
    jl, tl = _lti_pair(pts[:N0], cent, _icfg(jconfig))
    valid = np.ones(NN, bool)
    valid[[5, 40]] = False                       # padding rows
    dmask = np.zeros(CAP, bool)
    dmask[np.arange(0, N0, 11)] = True
    return kind, pts, jl, tl, valid, dmask


def _recall(lti_state, queries, pts_live, ids_live):
    g = lti_state.graph
    cfg = _icfg(tconfig)
    ids, *_ = tmem.search(g, torch.from_numpy(queries), cfg, k=5, L=24)
    d = ((queries[:, None] - pts_live[None]) ** 2).sum(-1)
    gt = ids_live[np.argsort(d, axis=1, kind="stable")[:, :5]]
    ids = ids.numpy()
    return ((ids[:, :, None] == gt[:, None]).any(2) & (ids >= 0)).mean()


def _live(merged):
    g = merged["active"] & ~merged["deleted"]
    return merged["vectors"][g], np.nonzero(g)[0]


def _compare_merge(kind, jl_out, js, tl_out, ts, queries):
    want = {k: np.asarray(getattr(jl_out.graph, k))
            for k in convert.GRAPH_FIELDS}
    want["codes"] = np.asarray(jl_out.codes)
    got = convert.lti_to_numpy(tl_out)
    for name in ("n_deleted", "n_inserted", "n_backedge_pairs",
                 "repair_cap_overflows", "n_backedge_targets"):
        assert int(getattr(js, name)) == getattr(ts, name), name
    np.testing.assert_array_equal(np.asarray(js.slots), ts.slots.numpy())
    for k in ("vectors", "active", "deleted", "start", "n_total", "codes"):
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    if kind == "integer":
        np.testing.assert_array_equal(want["adjacency"], got["adjacency"])
    else:
        same = (want["adjacency"] == got["adjacency"]).all(1).mean()
        assert same >= 0.90, same
        pts_live, ids_live = _live(want)
        r_port = _recall(tl_out, queries, pts_live, ids_live)
        jout = convert.lti_state(jl_out.graph, jl_out.codes,
                                 np.asarray(jl_out.codebook.centroids), "cpu")
        r_ref = _recall(jout, queries, pts_live, ids_live)
        assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)


# ------------------------------------------------------------- the kernel
def _sdc_rows(seed, B, C, kind):
    g = np.random.default_rng(seed)
    n = 200
    codes = g.integers(0, KSUB, (n, M)).astype(np.uint8)
    tables = (g.integers(0, 9, (M, KSUB, KSUB)).astype(np.float32)
              if kind == "integer"
              else (g.standard_normal((M, KSUB, KSUB)) ** 2).astype(
                  np.float32))
    ids = g.integers(0, n, (B, C)).astype(np.int32)
    ids[:, C // 2:] = ids[:, :C - C // 2]                 # duplicates
    ids[g.random((B, C)) < 0.1] = -1
    ok = (ids >= 0) & (g.random((B, C)) > 0.2)
    ok[0] = False                                          # all-inf row
    d_p = (g.integers(0, 30, (B, C)).astype(np.float32) if kind == "integer"
           else (g.random((B, C)) * 30).astype(np.float32))
    return d_p, codes, tables, ids, ok


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("B,C,Rk", [(3, 40, 8), (8, 80, 12), (2, 7, 16)])
def test_robust_prune_sdc_matches_jax_kernel(kind, alpha, B, C, Rk):
    d_p, codes, tables, ids, ok = _sdc_rows(C + Rk, B, C, kind)
    cand = codes[np.maximum(ids, 0)].astype(np.int32)
    w_ids, w_cnt = jops.robust_prune_sdc(
        jnp.asarray(d_p), jnp.asarray(cand), jnp.asarray(tables),
        jnp.asarray(ids), jnp.asarray(ok), alpha=alpha, R=Rk,
        use_kernel=True)
    t = [torch.from_numpy(x) for x in (d_p, cand, tables, ids, ok)]
    g_ids, g_cnt = ref.robust_prune_sdc_ref(*t, alpha=alpha, R=Rk)
    np.testing.assert_array_equal(np.asarray(w_ids), g_ids.numpy())
    np.testing.assert_array_equal(np.asarray(w_cnt), g_cnt.numpy())
    assert (g_ids.numpy()[0] == -1).all() and int(g_cnt[0]) == 0
    # The gather-fused wrapper takes the whole code table.
    f_ids, f_cnt = ops.robust_prune_sdc(
        t[0], torch.from_numpy(codes), t[2], t[3], t[4], alpha=alpha, R=Rk)
    assert torch.equal(f_ids, g_ids) and torch.equal(f_cnt, g_cnt)


def test_sdc_lut_and_prune_backend_match_reference():
    g = np.random.default_rng(4)
    cent = g.integers(-3, 4, (M, KSUB, D // M)).astype(np.float32)
    codes = g.integers(0, KSUB, (60, M)).astype(np.uint8)
    jt = jpq.sdc_tables(jpq.PQCodebook(jnp.asarray(cent)))
    tt = tpq.sdc_tables(tpq.PQCodebook(torch.from_numpy(cent)))
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    for p in (0, 7, 59):
        np.testing.assert_array_equal(
            np.asarray(jpq.sdc_lut(jt, jnp.asarray(codes[p]))),
            tpq.sdc_lut(tt, torch.from_numpy(codes[p])).numpy())
    # SDC equals the squared distance of the decoded vectors.
    dec = tpq.decode(tpq.PQCodebook(torch.from_numpy(cent)),
                     torch.from_numpy(codes), _pq(tconfig))
    be = SDCPrune(torch.from_numpy(codes), tt)
    ps = torch.tensor([3, 11], dtype=torch.int32)
    cand = torch.arange(60, dtype=torch.int32).expand(2, 60)
    d = be.anchor_dists(be.anchor_of(ps), cand)
    want = ((dec[ps.long()][:, None] - dec[None]) ** 2).sum(-1)
    assert torch.equal(d, want)


@pytest.mark.parametrize("cap", [None, 32])
def test_apply_back_edges_codes_matches_reference(cap):
    g = np.random.default_rng(8)
    n = 200
    adj = g.integers(0, n, (n, R)).astype(np.int32)
    adj[g.random((n, R)) < 0.3] = -1
    codes = g.integers(0, KSUB, (n, M)).astype(np.uint8)
    cent = g.integers(-3, 4, (M, KSUB, D // M)).astype(np.float32)
    jt = jpq.sdc_tables(jpq.PQCodebook(jnp.asarray(cent)))
    tt = tpq.sdc_tables(tpq.PQCodebook(torch.from_numpy(cent)))
    pj = g.integers(0, n, 160).astype(np.int32)
    pj[g.random(160) < 0.2] = -1
    pp = np.where(pj >= 0, g.integers(0, n, 160), -1).astype(np.int32)
    usable = g.random(n) > 0.05
    want = jins.apply_back_edges_codes(
        jnp.asarray(adj), jnp.asarray(codes), jt, jnp.asarray(usable),
        jnp.asarray(pj), jnp.asarray(pp), alpha=1.2, R=R, chunk=64,
        affected_cap=cap)
    got = tins.apply_back_edges_codes(
        torch.from_numpy(adj.copy()), torch.from_numpy(codes), tt,
        torch.from_numpy(usable), torch.from_numpy(pj), torch.from_numpy(pp),
        alpha=1.2, R=R, chunk=64, affected_cap=cap)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ------------------------------------------------------------- the merge
@pytest.mark.parametrize("use_sdc", [False, True])
@pytest.mark.parametrize("mode", ["global", "local"])
def test_streaming_merge_matches_reference(merge_setup, use_sdc, mode):
    kind, pts, jl, tl, valid, dmask = merge_setup
    newv = pts[N0:N0 + NN]
    jout, js = jmerge.streaming_merge(
        jl, jnp.asarray(newv), jnp.asarray(valid), jnp.asarray(dmask),
        _icfg(jconfig, use_kernel=False), _pq(jconfig), insert_chunk=32,
        block=64, use_sdc=use_sdc, repair_mode=mode)
    queries = pts[N0 + NN:]
    before = convert.lti_to_numpy(tl)
    for use_kernel in (None, True):           # plain engine, kernel wrappers
        tout, ts = tmerge.streaming_merge(
            tl, torch.from_numpy(newv), torch.from_numpy(valid),
            torch.from_numpy(dmask), _icfg(tconfig, use_kernel=use_kernel),
            _pq(tconfig), insert_chunk=32, block=64, use_sdc=use_sdc,
            repair_mode=mode)
        _compare_merge(kind, jout, js, tout, ts, queries)
        assert ts.n_inserted == NN - 2 and ts.n_deleted == len(
            np.arange(0, N0, 11))
        assert 0 < ts.n_prune_rows <= ts.n_backedge_targets
    after = convert.lti_to_numpy(tl)                 # the input LTI is intact
    for k, v in before.items():
        np.testing.assert_array_equal(v, after[k], err_msg=k)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_merge_delete_everything_then_reinsert(merge_setup, mode):
    """A Delete phase that empties the LTI hands the sentinel start to the
    insert phase, which re-seeds it from the first new slot."""
    kind, pts, jl, tl, *_ = merge_setup
    dmask = np.zeros(CAP, bool)
    dmask[:N0] = True
    newv = torch.from_numpy(pts[N0:N0 + 40])
    out, st = tmerge.streaming_merge(
        tl, newv, torch.ones(40, dtype=torch.bool), torch.from_numpy(dmask),
        _icfg(tconfig), _pq(tconfig), insert_chunk=32, block=64,
        repair_mode=mode)
    g = out.graph
    assert st.n_deleted == N0 and st.n_inserted == 40
    assert int(g.start) >= 0 and bool(g.active[g.start])
    assert int(g.active.sum()) == 40
    ids, *_ = tmem.search(g, newv[:4], _icfg(tconfig), k=1, L=24)
    assert (ids[:, 0] >= 0).all()


def test_adjacency_delta_mask():
    a = torch.tensor([[1, 2], [3, -1], [0, 0]], dtype=torch.int32)
    b = torch.tensor([[1, 2], [3, 4], [0, 0]], dtype=torch.int32)
    assert tmerge.adjacency_delta_mask(a, b).tolist() == [False, True,
                                                          False]


# --------------------------------------------------------------- the system
def _scfg(mod, **kw):
    base = dict(index=mod.IndexConfig(capacity=512, dim=D, R=R, L_build=16,
                                      L_search=24, alpha=1.2, beam_width=4),
                pq=_pq(mod), ro_snapshot_points=32, merge_threshold=64,
                temp_capacity=64, insert_batch=16, merge_block=64,
                reach_probe_samples=16)
    base.update(kw)
    return mod.SystemConfig(**base)


def _systems(g, **kw):
    base = g.integers(-3, 4, (256, D)).astype(np.float32)
    cent = g.integers(-3, 4, (M, KSUB, D // M)).astype(np.float32)
    jl, tl = _lti_pair(base, cent, _scfg(jconfig).index)
    table = np.full(512, -1, np.int64)
    table[:256] = np.arange(256)
    ref_sys = jsystem.FreshDiskANN(_scfg(jconfig, **kw), lti=jl,
                                   lti_ext_ids=table.copy())
    port = tsystem.FreshDiskANN(_scfg(tconfig, **kw), lti=tl,
                                lti_ext_ids=table.copy(), device="cpu")
    return ref_sys, port


_SYSTEM_CASES = {
    "threshold_local": dict(),
    "background": dict(background_merge=True),
    "global_repair": dict(local_repair_threshold=0.0),
}


@pytest.mark.parametrize("case", list(_SYSTEM_CASES))
def test_system_merge_and_consolidate_match_reference(case):
    """Threshold merges (foreground or on the worker thread), a forced
    merge after a delete and a re-insert, then ``consolidate``: the LTI,
    its ext-id table, the searches and the counters equal the
    reference's.  A merge started on the worker thread is joined before
    the next insert, so both systems see the same interleaving: which RO
    tiers a background merge snapshots, and whether a threshold crossed
    while it runs starts another, otherwise depend on thread timing."""
    g = np.random.default_rng(5)
    ref_sys, port = _systems(g, **_SYSTEM_CASES[case])
    new = g.integers(-3, 4, (150, D)).astype(np.float32)
    qs = g.integers(-3, 4, (20, D)).astype(np.float32)
    for s in (ref_sys, port):
        for i in range(150):
            s.insert(1000 + i, new[i])
            s.wait_merge()
            if i == 40:
                for e in (3, 17, 50, 1005, 1020):
                    s.delete(e)
        s.wait_merge()
        s.delete(5)
        s.delete(1100)
        s.insert(17, new[0] + 1)
        s.merge()
        s.wait_merge()
    assert port.stats.merges == ref_sys.stats.merges >= 3
    for name in ("local_repairs", "global_repairs", "reach_probes",
                 "unreachable_frac", "merge_backedge_targets",
                 "repair_cap_overflows", "snapshots", "flushes"):
        assert getattr(port.stats, name) == getattr(ref_sys.stats, name), name
    np.testing.assert_array_equal(np.asarray(ref_sys.lti.graph.adjacency),
                                  port.lti.graph.adjacency.numpy())
    np.testing.assert_array_equal(ref_sys.lti_ext_ids, port.lti_ext_ids)
    assert port.deleted_ext == ref_sys.deleted_ext
    assert port.size == ref_sys.size and not port.ro
    for a, b in zip(ref_sys.search_batch(qs, k=5), port.search_batch(qs, k=5)):
        np.testing.assert_array_equal(a, b)
    for s in (ref_sys, port):
        for e in (20, 21, 22, 1001):
            s.delete(e)
    assert port.consolidate() == ref_sys.consolidate() == 4
    assert port.consolidate() == 0
    np.testing.assert_array_equal(np.asarray(ref_sys.lti.graph.adjacency),
                                  port.lti.graph.adjacency.numpy())
    assert port.deleted_ext == ref_sys.deleted_ext
    assert port.stats.consolidations == ref_sys.stats.consolidations == 1
    for a, b in zip(ref_sys.search_batch(qs, k=5), port.search_batch(qs, k=5)):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------- oracle sweeps on the port alone
# The configuration and recall floor of tests/test_streaming_property.py
# (capacity 1024, R 16): at R 8 both packages miss the floor on the same
# streams, with the same hit counts.
SWEEP_D = 16
RECALL_FLOOR = 0.70


def _sweep_index(**kw):
    return tconfig.IndexConfig(capacity=1024, dim=SWEEP_D, R=16, L_build=24,
                               L_search=32, alpha=1.2, **kw)


def _sweep_cfg(**kw):
    base = dict(
        index=_sweep_index(),
        pq=tconfig.PQConfig(dim=SWEEP_D, m=4, ksub=16, kmeans_iters=3),
        ro_snapshot_points=24, merge_threshold=48, temp_capacity=128,
        insert_batch=8, merge_block=128)
    base.update(kw)
    return tconfig.SystemConfig(**base)


def run_interleaving(seed: int, n_ops: int = 120, *, explicit_merges=True,
                     **cfg_kw):
    """One random insert/delete/re-insert/merge/search stream on the port,
    mirrored in a dict; after every search: no deleted or unknown id, and
    recall@k against brute force over the oracle >= RECALL_FLOOR; at the
    end ``size`` equals the oracle's count."""
    rng = np.random.default_rng(seed)
    n0 = 64
    base = rng.standard_normal((n0, SWEEP_D)).astype(np.float32)
    sys_ = tsystem.bootstrap_system(base, np.arange(n0), _sweep_cfg(**cfg_kw),
                                    device="cpu", batch=16)
    oracle = {e: base[e] for e in range(n0)}
    graveyard = {}
    next_id = 1000

    def check_search():
        k = int(rng.integers(1, 6))
        q = rng.standard_normal((int(rng.integers(1, 5)), SWEEP_D)).astype(
            np.float32)
        ids, _ = sys_.search(q, k=k)
        for e in ids.ravel():
            if e >= 0:
                assert int(e) not in graveyard and int(e) in oracle, e
        keys = np.asarray(sorted(oracle))
        mat = np.stack([oracle[e] for e in keys])
        kk = min(k, len(keys))
        d = ((q[:, None] - mat[None]) ** 2).sum(-1)
        gt = keys[np.argsort(d, axis=1, kind="stable")[:, :kk]]
        hits = sum(len(set(r[r >= 0].tolist()) & set(t.tolist()))
                   for r, t in zip(ids, gt))
        assert hits / (kk * len(q)) >= RECALL_FLOOR, (seed, hits)

    for _ in range(n_ops):
        r = rng.random()
        if r < 0.45 or not oracle:
            v = rng.standard_normal(SWEEP_D).astype(np.float32)
            sys_.insert(next_id, v)
            oracle[next_id] = v
            next_id += 1
        elif r < 0.60 and len(oracle) > 4:
            e = int(rng.choice(sorted(oracle)))
            sys_.delete(e)
            graveyard[e] = oracle.pop(e)
        elif r < 0.70 and graveyard:
            e = int(rng.choice(sorted(graveyard)))
            v = graveyard.pop(e)
            sys_.insert(e, v)
            oracle[e] = v
        elif r < 0.75 and explicit_merges:
            sys_.merge()
            sys_.wait_merge()
        else:
            check_search()
    sys_.wait_merge()
    check_search()
    sys_._flush_inserts()
    assert sys_.size == len(oracle)
    return sys_


_SWEEPS = {
    "seed0": (0, {}),
    "seed1": (1, {}),
    "seed2": (2, {}),
    "background_merge": (11, dict(explicit_merges=False,
                                  background_merge=True, merge_threshold=32)),
    "localized_repair": (21, dict(index=_sweep_index(repair_mode="local"))),
    "locality_order": (31, dict(locality_order=True)),
}


@pytest.mark.parametrize("case", list(_SWEEPS))
def test_streaming_interleavings(case):
    seed, kw = _SWEEPS[case]
    s = run_interleaving(seed, **kw)
    assert s.stats.merges >= 1


def test_reinsert_after_delete_across_merge():
    rng = np.random.default_rng(4)
    base = rng.standard_normal((48, SWEEP_D)).astype(np.float32)
    s = tsystem.bootstrap_system(base, np.arange(48), _sweep_cfg(),
                                 device="cpu", batch=16)
    s.delete(7)
    s.merge()
    ids, _ = s.search(base[7:8], k=3)
    assert 7 not in ids[0]
    s.insert(7, base[7])
    ids, _ = s.search(base[7:8], k=1)
    assert int(ids[0, 0]) == 7


def test_reinsert_with_new_vector_supersedes_old_copy():
    """delete(e) + insert(e, v2) + merge leaves exactly one LTI copy of e,
    holding v2."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((48, SWEEP_D)).astype(np.float32)
    s = tsystem.bootstrap_system(base, np.arange(48), _sweep_cfg(),
                                 device="cpu", batch=16)
    v2 = base[7] + 100.0
    s.delete(7)
    s.insert(7, v2)
    s._flush_inserts()
    s.ro.append(s.rw)
    s.rw = s._new_temp()
    s.merge()
    slots = np.nonzero(s.lti_ext_ids == 7)[0]
    assert len(slots) == 1
    np.testing.assert_allclose(s.lti.graph.vectors[slots[0]].numpy(), v2)
    ids, d = s.search(base[7:8], k=3)
    row = dict(zip(ids[0].tolist(), d[0].tolist()))
    assert 7 not in row or row[7] > 1.0
    ids, _ = s.search(v2[None], k=1)
    assert int(ids[0, 0]) == 7


def test_reachability_gauge_low_rate_cycles():
    """Low-rate delete/repair cycles: the gauge is probed after every merge,
    stays a fraction and does not trend upward."""
    rng = np.random.default_rng(13)
    base = rng.standard_normal((96, SWEEP_D)).astype(np.float32)
    s = tsystem.bootstrap_system(
        base, np.arange(96),
        _sweep_cfg(local_repair_threshold=1.0, reach_probe_samples=64),
        device="cpu", batch=16)
    gauges, next_id = [], 1000
    for _ in range(4):
        live = sorted(e for e in range(96) if e not in s.deleted_ext)
        for e in rng.choice(live, 2, replace=False):
            s.delete(int(e))
        for _ in range(4):
            s.insert(next_id, rng.standard_normal(SWEEP_D).astype(
                np.float32))
            next_id += 1
        s._flush_inserts()
        s.merge()
        gauges.append(s.stats.unreachable_frac)
        assert 0.0 <= gauges[-1] <= 1.0
    assert s.stats.reach_probes >= 4 and s.stats.local_repairs >= 1
    assert gauges[-1] <= gauges[0] + 0.125, gauges
    assert s.stats.repair_escalations <= s.stats.global_repairs + 1
