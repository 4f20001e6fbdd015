"""Filtered and multi-tenant search in the port against the reference,
mirroring ``tests/test_filtered.py``.

Both packages start from the reference's labelled bootstrap LTI (carried
across with ``repro_torch.convert``; the port's own labelled
``bootstrap_system`` must give the same label tables) and take the same
labelled, tenanted stream of inserts through two RW -> RO rollovers, so
filters act on the LTI lane and on the temp lanes.  Labels follow the
ladder of ``tests/test_filtered.py`` (bit 0 on every point, bit 1 on every
2nd, bit 2 on every 10th, bit 3 on every 100th) and tenants are i % 4.

Integer fixture: ids, dists and the lane counters (hops, cmps) equal bit
for bit.  Gaussian fixture: ids equal except at near ties, dists to rtol
1e-5.  Either way no returned id fails its predicate, a spec every live
point matches returns exactly the unfiltered result, and the filter never
changes hops or cmps.  The filter follows points through delete, merge and
consolidate; ``search_disk`` filters its LTI lane against the layout's
label tables.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

from repro.core import config as jconfig  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import system as jsystem  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import system as tsystem  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N0, N_STREAM, D, NQ, N_TENANTS = 256, 120, 16, 24, 4
SEL_BITS = {0: 1.0, 1: 0.5, 2: 0.1, 3: 0.01}


def _labels_for(i: int) -> list:
    ls = [0]
    if i % 2 == 0:
        ls.append(1)
    if i % 10 == 0:
        ls.append(2)
    if i % 100 == 0:
        ls.append(3)
    return ls


def _cfg(mod, **kw):
    base = dict(
        index=mod.IndexConfig(capacity=512, dim=D, R=8, L_build=16,
                              L_search=32, alpha=1.2, beam_width=4),
        pq=mod.PQConfig(dim=D, m=4, ksub=16, kmeans_iters=3),
        ro_snapshot_points=48, merge_threshold=100_000, temp_capacity=96,
        insert_batch=16, batch_queries=16, filter_words=1)
    base.update(kw)
    return mod.SystemConfig(**base)


def _data(kind):
    g = np.random.default_rng(5)
    n = N0 + N_STREAM + NQ
    if kind == "integer":
        x = g.integers(-3, 4, (n, D)).astype(np.float32)
    else:
        centers = g.standard_normal((8, D)) * 3.0
        x = (centers[g.integers(0, 8, n)]
             + g.standard_normal((n, D))).astype(np.float32)
    return x[:N0], x[N0:N0 + N_STREAM], x[N0 + N_STREAM:]


def _stream(sys_, new):
    for j in range(N_STREAM):
        i = N0 + j
        sys_.insert(1000 + j, new[j], labels=_labels_for(i),
                    tenant=i % N_TENANTS)


@pytest.fixture(scope="module", params=["integer", "gaussian"])
def world(request):
    kind = request.param
    base, new, qs = _data(kind)
    labels = [_labels_for(i) for i in range(N0)]
    tenants = [i % N_TENANTS for i in range(N0)]
    boot = jsystem.bootstrap_system(base, np.arange(N0), _cfg(jconfig),
                                    labels=labels, tenants=tenants, batch=32)
    cb = boot.lti.codebook.centroids
    port_boot = tsystem.bootstrap_system(
        base, np.arange(N0), _cfg(tconfig), labels=labels, tenants=tenants,
        device="cpu", batch=32,
        codebook=convert.lti_state(boot.lti.graph, boot.lti.codes, cb,
                                   "cpu").codebook)
    truth = {i: (base[i], _labels_for(i), i % N_TENANTS) for i in range(N0)}
    for j in range(N_STREAM):
        i = N0 + j
        truth[1000 + j] = (new[j], _labels_for(i), i % N_TENANTS)

    def ref(stream=True, **kw):
        s = jsystem.FreshDiskANN(_cfg(jconfig, **kw), lti=boot.lti,
                                 lti_ext_ids=boot.lti_ext_ids.copy())
        s.lti_labels = boot.lti_labels.copy()
        if stream:
            _stream(s, new)
        return s

    def port(stream=True, **kw):
        s = tsystem.FreshDiskANN(
            _cfg(tconfig, **kw),
            lti=convert.lti_state(boot.lti.graph, boot.lti.codes, cb, "cpu"),
            lti_ext_ids=convert.ext_table(boot.lti_ext_ids),
            lti_labels=port_boot.lti_labels.copy(), device="cpu")
        if stream:
            _stream(s, new)
        return s

    return dict(kind=kind, ref=ref, port=port, boot=boot,
                port_boot=port_boot, truth=truth, qs=qs, base=base, new=new,
                r=ref(), p=port())


def _same(kind, got, want):
    """Integer: bit for bit.  Gaussian: dists to rtol 1e-5 and ids equal
    wherever the row holds no near tie."""
    (gi, gd), (wi, wd) = got, want
    assert gi.shape == wi.shape and gi.dtype == np.int64
    if kind == "integer":
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
        return
    np.testing.assert_allclose(gd, wd, rtol=1e-5)
    fin = np.isfinite(wd)
    tie = np.zeros(wd.shape, bool)
    with np.errstate(invalid="ignore"):
        close = np.abs(np.diff(wd, axis=1)) <= 1e-5 * np.abs(wd[:, 1:])
    tie[:, 1:] |= close
    tie[:, :-1] |= close
    np.testing.assert_array_equal(gi[fin & ~tie], wi[fin & ~tie])


def _valid(ids, truth, pred):
    for e in (int(x) for x in ids.ravel() if x >= 0):
        assert pred(*truth[e][1:]), f"id {e} fails the predicate"


def _oracle(truth, pred, queries, k):
    """Brute-force filtered ground truth over the points passing pred."""
    keys = np.asarray([e for e in sorted(truth) if pred(*truth[e][1:])])
    mat = np.stack([truth[e][0] for e in keys])
    d = ((mat[None] - queries[:, None]) ** 2).sum(-1)
    return keys[np.argsort(d, axis=1, kind="stable")[:, :k]]


def _recall(ids, gt):
    return float(np.mean([len(set(r[r >= 0].tolist()) & set(g.tolist()))
                          / len(g) for r, g in zip(ids, gt)]))


def _widen(sel, k=5, L_search=32):
    """The reference's clients' widening for a post-filter: k_eff rows,
    L at least twice that."""
    k_eff = k if sel == 1.0 else min(256, int(np.ceil(k / sel * 1.5)))
    return k_eff, max(L_search, 2 * k_eff)


def _lane_counters(sys_, q, unified, fspec, **extra):
    """(ids, dists, hops, cmps) of one micro-batch through ``unified`` on
    the system's own bundle and (filtered) drop masks."""
    rw_t, ro_temps, lti_entry = sys_._capture_lanes()
    bundle = sys_._lane_bundle(rw_t, ro_temps, lti_entry)
    key, stack, t_tabs, l_tab, tables_np, label_tabs = bundle
    if fspec is None:
        t_drop, l_drop = sys_._drop_mask(key, tables_np)
    else:
        t_drop, l_drop = sys_._filter_drop(key, tables_np, label_tabs, fspec)
    return unified(stack, t_tabs, l_tab, t_drop, l_drop, q, **extra)


# ------------------------------------------------------------ bootstrap
def test_bootstrap_labels_match_reference(world):
    """The port's labelled bootstrap tags slot i with row i's labels and
    tenant, as the reference's; on the integer fixture the graph is the
    reference's too."""
    pb, jb = world["port_boot"], world["boot"]
    np.testing.assert_array_equal(pb.lti_labels.bits, jb.lti_labels.bits)
    np.testing.assert_array_equal(pb.lti_labels.tenant,
                                  jb.lti_labels.tenant)
    assert pb.lti_labels.bits.dtype == np.uint32
    assert (pb.lti_labels.tenant[N0:] == tgraph.NO_TENANT).all()
    if world["kind"] == "integer":
        np.testing.assert_array_equal(pb.lti.graph.adjacency.numpy(),
                                      np.asarray(jb.lti.graph.adjacency))
    with pytest.raises(ValueError, match="out of range"):
        tsystem.bootstrap_system(world["base"][:8], np.arange(8),
                                 _cfg(tconfig), labels=[[32]] * 8,
                                 device="cpu", batch=8)


def test_stream_labels_every_tier(world):
    """After the stream both packages hold the same label tables in the
    RW tier and each RO snapshot."""
    r, p = world["r"], world["p"]
    assert len(p.ro) == len(r.ro) == 2 and p.rw.n == r.rw.n > 0
    for a, b in zip([p.rw] + p.ro, [r.rw] + r.ro):
        np.testing.assert_array_equal(a.ext_ids, b.ext_ids)
        np.testing.assert_array_equal(a.labels.bits, b.labels.bits)
        np.testing.assert_array_equal(a.labels.tenant, b.labels.tenant)


# ------------------------------------------------------------ selectivity
@pytest.mark.parametrize("bit,sel", sorted(SEL_BITS.items()))
def test_filtered_search_matches_reference(world, bit, sel):
    """Each rung of the ladder, k and L widened as the reference's clients
    do: the port's rows are the reference's, every returned id carries the
    bit, and the leading k rows' recall against the filtered brute force
    is the reference's."""
    r, p, qs, truth = world["r"], world["p"], world["qs"], world["truth"]
    k_eff, L = _widen(sel)
    spec_t, spec_j = (tgraph.FilterSpec(all_of=(bit,)),
                      jgraph.FilterSpec(all_of=(bit,)))
    got = p.search_batch(qs, k_eff, L=L, filter=spec_t)
    want = r.search_batch(qs, k_eff, L=L, filter=spec_j)
    _same(world["kind"], got, want)
    _valid(got[0], truth, lambda ls, t: bit in ls)
    gt = _oracle(truth, lambda ls, t: bit in ls, qs, 5)
    rec_p, rec_r = _recall(got[0][:, :5], gt), _recall(want[0][:, :5], gt)
    assert abs(rec_p - rec_r) <= 0.01 and rec_p >= 0.5, (rec_p, rec_r)


def test_filter_leaves_hops_and_cmps(world):
    """The filter is applied after the search: under each spec the lane
    counters equal the unfiltered ones, and the reference's."""
    r, p, qs = world["r"], world["p"], world["qs"]
    q_t = torch.from_numpy(qs[:16])
    import jax.numpy as jnp
    q_j = jnp.asarray(qs[:16])
    base = _lane_counters(p, q_t, tindex.unified_search, None,
                          cfg=p.cfg.index, k=5, k_lane=13, L=32,
                          beam_width=4)
    for spec in ((1,), (3,), None):
        kw = dict(tenant=2) if spec is None else dict(all_of=spec)
        a = _lane_counters(p, q_t, tindex.unified_search,
                           tgraph.FilterSpec(**kw), cfg=p.cfg.index, k=5,
                           k_lane=13, L=32, beam_width=4)
        b = _lane_counters(r, q_j, jindex.unified_search,
                           jgraph.FilterSpec(**kw), cfg=r.cfg.index, k=5,
                           k_lane=13, L=32, beam_width=4)
        for x, y in zip(a[2:], base[2:]):
            assert torch.equal(x, y)
        for x, y in zip(a[2:], b[2:]):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        _same(world["kind"], (a[0].numpy().astype(np.int64), a[1].numpy()),
              (np.asarray(b[0]).astype(np.int64), np.asarray(b[1])))


def test_selectivity_one_bit_parity(world):
    """A filter every point matches is the unfiltered call: ids, dists
    and dispatches (the reference's pinned regression)."""
    p, qs = world["p"], world["qs"]
    d0 = p.stats.search_dispatches
    ids_u, dist_u = p.search_batch(qs, 10)
    du = p.stats.search_dispatches - d0
    d0 = p.stats.search_dispatches
    ids_f, dist_f = p.search_batch(qs, 10,
                                   filter=tgraph.FilterSpec(all_of=(0,)))
    assert p.stats.search_dispatches - d0 == du
    np.testing.assert_array_equal(ids_f, ids_u)
    np.testing.assert_array_equal(dist_f, dist_u)


def test_empty_filterspec_is_unfiltered(world):
    """FilterSpec() constrains nothing and is not counted as filtered."""
    p, qs = world["p"], world["qs"]
    f0 = p.stats.filtered_searches
    ids_u, dist_u = p.search_batch(qs, 5)
    ids_e, dist_e = p.search_batch(qs, 5, filter=tgraph.FilterSpec())
    np.testing.assert_array_equal(ids_e, ids_u)
    np.testing.assert_array_equal(dist_e, dist_u)
    assert p.stats.filtered_searches == f0
    assert tgraph.FilterSpec().is_empty
    assert hash(tgraph.FilterSpec(all_of=(2, 1))) == hash(
        tgraph.FilterSpec(all_of=(1, 2)))


# ------------------------------------------------------------- tenants
def test_tenant_filter_matches_reference(world):
    r, p, qs, truth = world["r"], world["p"], world["qs"], world["truth"]
    k_eff, L = _widen(1 / N_TENANTS)
    for tenant in range(N_TENANTS):
        got = p.search_batch(qs, k_eff, L=L,
                             filter=tgraph.FilterSpec(tenant=tenant))
        want = r.search_batch(qs, k_eff, L=L,
                              filter=jgraph.FilterSpec(tenant=tenant))
        _same(world["kind"], got, want)
        _valid(got[0], truth, lambda ls, t: t == tenant)
        gt = _oracle(truth, lambda ls, t: t == tenant, qs, 5)
        assert _recall(got[0][:, :5], gt) >= 0.5


def test_tenant_and_label_compose(world):
    """tenant + label in one spec: the AND of both predicates."""
    r, p, qs, truth = world["r"], world["p"], world["qs"], world["truth"]
    got = p.search_batch(qs, 5, L=128,
                         filter=tgraph.FilterSpec(all_of=(1,), tenant=2))
    want = r.search_batch(qs, 5, L=128,
                          filter=jgraph.FilterSpec(all_of=(1,), tenant=2))
    _same(world["kind"], got, want)
    _valid(got[0], truth, lambda ls, t: 1 in ls and t == 2)
    got = p.search_batch(qs, 5, L=64, filter=tgraph.FilterSpec(any_of=(2, 3)))
    want = r.search_batch(qs, 5, L=64,
                          filter=jgraph.FilterSpec(any_of=(2, 3)))
    _same(world["kind"], got, want)
    _valid(got[0], truth, lambda ls, t: 2 in ls or 3 in ls)


def test_tenant_search_accounting(world):
    """Queries (not programs) counted as filtered and per tenant, as the
    reference counts them, and reported by ``serving_snapshot``."""
    r, p, qs = world["ref"](), world["port"](), world["qs"]
    for s, FS in ((r, jgraph.FilterSpec), (p, tgraph.FilterSpec)):
        s.search_batch(qs, 3, filter=FS(tenant=1))
        s.search_batch(qs[:5], 3, filter=FS(all_of=(1,)))
        s.search_batch(qs[:0], 3, filter=FS(tenant=3))
        s.search_batch(qs[:2], 3)
    for f in ("searches", "filtered_searches", "tenant_searches",
              "search_dispatches"):
        assert getattr(p.stats, f) == getattr(r.stats, f), f
    assert p.stats.tenant_searches == {1: NQ, 3: 0}
    snap = p.stats.serving_snapshot()
    assert snap["filtered_searches"] == NQ + 5
    assert snap["tenant_searches"] == {1: NQ, 3: 0}
    assert snap["tenant_sheds"] == {}


def test_sequential_oracle_and_shards_filtered(world):
    """``batch_fanout=False`` and ``shard_lti=2`` under a filter: the
    unified fan-out's rows, and the reference's oracle's."""
    qs = world["qs"]
    want = world["p"].search_batch(qs, 8, filter=tgraph.FilterSpec(
        all_of=(1,), tenant=0))
    for kw in (dict(batch_fanout=False), dict(shard_lti=2)):
        p = world["port"](**kw)
        got = p.search_batch(qs, 8, filter=tgraph.FilterSpec(
            all_of=(1,), tenant=0))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    r = world["ref"](batch_fanout=False)
    _same(world["kind"], want, r.search_batch(
        qs, 8, filter=jgraph.FilterSpec(all_of=(1,), tenant=0)))


def test_filter_cache_follows_deletes_and_flushes(world):
    """The per-spec masks are cached under (lanes, delete epoch): a delete
    and a flush retire them, and the results follow the reference."""
    r, p, qs = world["ref"](), world["port"](), world["qs"]
    spec_t, spec_j = (tgraph.FilterSpec(all_of=(1,)),
                      jgraph.FilterSpec(all_of=(1,)))
    first = p.search_batch(qs, 5, filter=spec_t)
    masks = p._filter_cache[2][spec_t]
    p.search_batch(qs, 5, filter=spec_t)
    assert p._filter_cache[2][spec_t] is masks          # a hit
    victim = int(first[0][0, 0])
    for s, FS, spec in ((r, jgraph.FilterSpec, spec_j),
                        (p, tgraph.FilterSpec, spec_t)):
        s.delete(victim)
        s.insert(5000, world["new"][0] + 1.0, labels=[1], tenant=1)
    got = p.search_batch(qs, 5, filter=spec_t)
    assert p._filter_cache[2][spec_t] is not masks
    assert victim not in got[0]
    _same(world["kind"], got, r.search_batch(qs, 5, filter=spec_j))


# -------------------------------------------------------- lifecycle
@pytest.mark.parametrize("repair", ["merge", "consolidate"])
def test_filters_survive_delete_and_merge(world, repair):
    """Labels follow points through deletes and a StreamingMerge (RO points
    scattered into merged slots, deleted rows cleared) or a consolidate:
    the LTI's label table is the reference's, and so are the filtered
    results, with no deleted id and no cross-tenant leak."""
    r, p, qs, truth = world["ref"](), world["port"](), world["qs"], \
        world["truth"]
    victims = [4, 8, 1000, 1004, 1060]
    for s in (r, p):
        for e in victims:
            s.delete(e)
        if repair == "merge":
            s.merge()
        else:
            assert s.consolidate(mode="global") == 2
    if repair == "merge":
        assert p.stats.merges == 1 and not p.ro
    np.testing.assert_array_equal(p.lti_ext_ids, r.lti_ext_ids)
    np.testing.assert_array_equal(p.lti_labels.bits, r.lti_labels.bits)
    np.testing.assert_array_equal(p.lti_labels.tenant, r.lti_labels.tenant)
    live = p.lti_ext_ids >= 0
    for slot in np.nonzero(live)[0][::7]:
        e = int(p.lti_ext_ids[slot])
        assert tgraph.unpack_labels(p.lti_labels.bits[slot]) == truth[e][1]
        assert p.lti_labels.tenant[slot] == truth[e][2]
    assert (p.lti_labels.tenant[~live] == tgraph.NO_TENANT).all()
    for tenant in range(N_TENANTS):
        got = p.search_batch(qs, 10, L=64,
                             filter=tgraph.FilterSpec(tenant=tenant))
        want = r.search_batch(qs, 10, L=64,
                              filter=jgraph.FilterSpec(tenant=tenant))
        _same(world["kind"], got, want)
        assert not np.isin(got[0], victims).any()
        _valid(got[0], truth, lambda ls, t: t == tenant)


def test_locality_flush_carries_labels(world):
    """With ``locality_order`` a flush permutes its buffer: each point's
    labels and tenant land in its slot all the same."""
    p, truth = world["port"](locality_order=True), world["truth"]
    assert len(p.ro) == 2
    for t in [p.rw] + p.ro:
        for slot in np.nonzero(t.ext_ids >= 0)[0]:
            e = int(t.ext_ids[slot])
            assert tgraph.unpack_labels(t.labels.bits[slot]) == truth[e][1]
            assert t.labels.tenant[slot] == truth[e][2]


def test_buffered_delete_drops_its_labels(world):
    """A delete of a buffered point drops its label row and tenant in step
    with its id and vector."""
    p = world["port"](stream=False)
    v = world["new"]
    p.insert(7000, v[0], labels=[1], tenant=3)
    p.insert(7001, v[1], labels=[2])
    p.insert(7002, v[2], tenant=1)
    p.delete(7001)
    assert p._insert_buf_id == [7000, 7002]
    assert [tgraph.unpack_labels(b) for b in p._insert_buf_bits] == [[1], []]
    assert p._insert_buf_tenant == [3, 1]
    p._flush_inserts()
    assert p.rw.labels.tenant[:2].tolist() == [3, 1]


def test_filtered_search_disk(world, tmp_path):
    """The disk path honours the spec with the layout's label tables: equal
    to the sequential oracle's filtered ``search_batch`` (the cache off),
    before and after a merge delta-patches the layout, and the layout's
    tables equal the LTI's."""
    from repro_torch.storage import open_layout
    qs, truth = world["qs"], world["truth"]
    p = world["port"](storage_dir=str(tmp_path / "store"),
                      adjacency_cache_mb=0, batch_fanout=False)
    for step in ("bootstrap", "merge"):
        if step == "merge":
            for e in (6, 1002):
                p.delete(e)
            p.merge()
        lay = open_layout(p._storage_path())
        np.testing.assert_array_equal(lay.label_bits, p.lti_labels.bits)
        np.testing.assert_array_equal(lay.label_tenant, p.lti_labels.tenant)
        lay.close()
        for spec in (tgraph.FilterSpec(tenant=1),
                     tgraph.FilterSpec(all_of=(1,))):
            got = p.search_disk(qs, 8, filter=spec)
            want = p.search_batch(qs, 8, filter=spec)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            _valid(got[0], truth, lambda ls, t, s=spec:
                   (s.tenant is None or t == s.tenant)
                   and all(b in ls for b in s.all_of))
            assert (got[0][:, 0] >= 0).all()
    p.close_storage()


# ------------------------------------------------------ unit: bit packing
def test_pack_unpack_roundtrip():
    for mod in (tgraph, jgraph):
        row = mod.pack_labels([0, 3, 31, 32, 63], 2)
        assert row.dtype == np.uint32 and row.shape == (2,)
        assert mod.unpack_labels(row) == [0, 3, 31, 32, 63]
        with pytest.raises(ValueError, match="out of range"):
            mod.pack_labels([64], 2)
    g = np.random.default_rng(2)
    for _ in range(20):
        ls = sorted(set(g.integers(0, 96, g.integers(0, 12)).tolist()))
        np.testing.assert_array_equal(tgraph.pack_labels(ls, 3),
                                      jgraph.pack_labels(ls, 3))
        assert tgraph.unpack_labels(tgraph.pack_labels(ls, 3)) == ls


def test_filter_match_semantics():
    tab = tgraph.LabelTable(4, 1)
    tab.set_row(0, tgraph.pack_labels([0, 1], 1), 7)
    tab.set_row(1, tgraph.pack_labels([1], 1), 7)
    tab.set_row(2, tgraph.pack_labels([0], 1), 8)
    FS = tgraph.FilterSpec
    assert tgraph.filter_match(tab, FS(all_of=(0, 1))).tolist() == [
        True, False, False, False]
    assert tgraph.filter_match(tab, FS(any_of=(0, 1))).tolist() == [
        True, True, True, False]
    assert tgraph.filter_match(tab, FS(tenant=7)).tolist() == [
        True, True, False, False]
    assert tgraph.filter_match(tab, FS(all_of=(0,), tenant=8)).tolist() == [
        False, False, True, False]
    # Random tables and specs: the reference's matches.
    g = np.random.default_rng(4)
    bits = g.integers(0, 2**32, (64, 2), dtype=np.uint64).astype(np.uint32)
    ten = g.integers(-1, 3, 64).astype(np.int32)
    jt = jgraph.LabelTable(64, 2, bits, ten)
    tt = tgraph.LabelTable(64, 2, bits, ten)
    for _ in range(30):
        kw = dict(all_of=tuple(g.integers(0, 64, g.integers(0, 3))),
                  any_of=tuple(g.integers(0, 64, g.integers(0, 3))),
                  tenant=None if g.random() < 0.5 else int(g.integers(-1, 3)))
        np.testing.assert_array_equal(
            tgraph.filter_match(tt, tgraph.FilterSpec(**kw)),
            jgraph.filter_match(jt, jgraph.FilterSpec(**kw)))


def test_label_table_ops():
    """copy, clear_rows, grow: the reference's semantics."""
    tab = tgraph.LabelTable(4, 1)
    tab.set_row(1, tgraph.pack_labels([5], 1), 2)
    c = tab.copy()
    c.clear_rows(np.array([False, True, False, False]))
    assert tab.tenant[1] == 2 and c.tenant[1] == tgraph.NO_TENANT
    assert c.bits[1, 0] == 0 and tab.bits[1, 0] == 1 << 5
    big = tab.grow(6)
    assert big.capacity == 6 and big.tenant[1] == 2 and big.tenant[5] == -1
    assert tab.grow(4) is tab
    with pytest.raises(ValueError, match="shrink"):
        tab.grow(2)


def test_cpu_filtered_search_never_reaches_a_kernel(world):
    ops.reset_launches()
    world["p"].search_batch(world["qs"][:4], 5,
                            filter=tgraph.FilterSpec(tenant=1))
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def test_filterspec_is_frozen():
    spec = tgraph.FilterSpec(all_of=(3, 1), tenant=2)
    assert spec.all_of == (1, 3)
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.tenant = 4
