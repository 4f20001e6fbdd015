"""Crash recovery in the port (§5.6), mirroring the label-free cases of
``tests/test_recovery_matrix.py``, and the on-disk formats shared with the
JAX package.

Each crash case compares the recovered system with a never-crashed twin of
the same package that saw the same operations (``size``, the DeleteList,
search ids and dists equal) and with the reference recovered from the same
stream (search ids and dists equal, the same number of records replayed):

  * a crash before any merge truncated the log (snapshot + suffix);
  * a crash after a threshold merge snapshotted and truncated it;
  * a stale WAL offset in the same epoch (replay the whole short log);
  * an empty suffix;
  * no truncation without ``snapshot_dir``;
  * recovery from a decoupled-layout snapshot, with ``search_disk``.

Interop: the two packages write byte-identical WAL files for the same
operations and each replays the other's; a snapshot written by either
(with and without ``storage_dir``) is loaded by the other.

Labels (the labelled crash matrix of ``tests/test_recovery_matrix.py``):
every point carries a label bit and a tenant, so the WAL holds op-2
records, snapshots and layouts hold label tables.  A crash before any
truncation (snapshot + suffix), after a merge's truncation, and after a
merge with ``storage_dir`` (a layout snapshot) must recover the twin's
ext-id -> (tenant, bits) map, the reference's label tables and the
reference's filtered results; labelled WALs, snapshots and layouts are
read across packages both ways.  Integer fixtures: every comparison is bit
for bit.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import config as jconfig  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import index as jmem  # noqa: E402
from repro.core import lti as jlti  # noqa: E402
from repro.core import pq as jpq  # noqa: E402
from repro.core import system as jsystem  # noqa: E402
from repro.core import wal as jwal  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import system as tsystem  # noqa: E402
from repro_torch.core import wal as twal  # noqa: E402

CAP, D, R, M, KSUB, N0, NQ = 512, 16, 8, 4, 16, 200, 12


def _cfg(mod, tmp, wal="wal", snaps=None, merge_threshold=100_000, **kw):
    return mod.SystemConfig(
        index=mod.IndexConfig(capacity=CAP, dim=D, R=R, L_build=16,
                              L_search=24, alpha=1.2, beam_width=2),
        pq=mod.PQConfig(dim=D, m=M, ksub=KSUB, kmeans_iters=3),
        ro_snapshot_points=32, merge_threshold=merge_threshold,
        temp_capacity=96, insert_batch=16,
        wal_dir=str(tmp / wal) if wal else None,
        snapshot_dir=str(tmp / snaps) if snaps else None, **kw)


@pytest.fixture(scope="module")
def data():
    """Integer points and codebook, the reference's bootstrap graph and
    its codes (shared by every system of both packages), and queries."""
    g = np.random.default_rng(21)
    pts = g.integers(-3, 4, (N0 + 200, D)).astype(np.float32)
    cent = g.integers(-3, 4, (M, KSUB, D // M)).astype(np.float32)
    icfg = _cfg(jconfig, None, wal=None).index
    jg = jmem.build(pts[:N0], icfg, batch=32)
    codes = np.zeros((CAP, M), np.uint8)
    codes[:N0] = np.asarray(jpq.encode(
        jpq.PQCodebook(jnp.asarray(cent)), jnp.asarray(pts[:N0]),
        _cfg(jconfig, None, wal=None).pq))
    graph = {k: np.asarray(getattr(jg, k)) for k in convert.GRAPH_FIELDS}
    qs = g.integers(-3, 4, (NQ, D)).astype(np.float32)
    return pts, graph, codes, cent, qs


PORT, REF = "port", "ref"
_MOD = {PORT: (tconfig, tsystem), REF: (jconfig, jsystem)}


def _boot(pkg, cfg, data, labelled=False):
    """A system over the bootstrap LTI (the static build is durable by
    construction); ``labelled``: slot i carries label i % 4 and tenant
    i % 3."""
    _, graph, codes, cent, _ = data
    table = np.full(CAP, -1, np.int64)
    table[:N0] = np.arange(N0)
    lb = None
    if labelled:
        mod = tgraph if pkg == PORT else jgraph
        lb = mod.LabelTable(CAP, cfg.filter_words)
        for i in range(N0):
            lb.set_row(i, mod.pack_labels([i % 4], cfg.filter_words),
                       i % N_TEN)
    if pkg == PORT:
        return tsystem.FreshDiskANN(
            cfg, lti=convert.lti_state(graph, codes, cent, "cpu"),
            lti_ext_ids=table, device="cpu", lti_labels=lb)
    lti = jlti.LTIState(
        jgraph.GraphState(**{k: jnp.asarray(v) for k, v in graph.items()}),
        jnp.asarray(codes), jpq.PQCodebook(jnp.asarray(cent)))
    s = jsystem.FreshDiskANN(cfg, lti=lti, lti_ext_ids=table)
    if labelled:
        s.lti_labels = lb
    return s


def _empty(pkg, cfg):
    if pkg == PORT:
        return tsystem.FreshDiskANN(cfg, device="cpu")
    return jsystem.FreshDiskANN(cfg)


def _apply(sys_, ops):
    for op in ops:
        if op[0] == "i":
            sys_.insert(op[1], op[2])
        elif op[0] == "il":
            sys_.insert(op[1], op[2], labels=op[3], tenant=op[4])
        else:
            sys_.delete(op[1])


def _traffic(pts, start, n, id0):
    return [("i", id0 + i, pts[start + i]) for i in range(n)]


N_TEN = 3


def _labelled_traffic(pts, start, n, id0):
    """Labelled inserts (the reference matrix's: label i % 4, tenant
    (id) % 3; every 5th without a tenant, every 7th without labels)."""
    return [("il", id0 + i, pts[start + i],
             [i % 4] if i % 7 else None,
             None if i % 5 == 0 else (id0 + i) % N_TEN) for i in range(n)]


def _search(sys_, qs):
    return sys_.search_batch(qs, k=5)


def _assert_twinned(recovered, twin, qs):
    assert recovered.size == twin.size
    assert recovered.deleted_ext == twin.deleted_ext
    for a, b in zip(_search(recovered, qs), _search(twin, qs)):
        np.testing.assert_array_equal(a, b)


def _close(*systems):
    for s in systems:
        s.close_storage()
        if s.wal:
            s.wal.close()


def _run_case(case, pkg, tmp, data):
    """One crash case for one package -> (recovered, twin, records
    replayed, expected count)."""
    pts, *_, qs = data
    tmp = tmp / pkg
    cfgm, _ = _MOD[pkg]
    if case == "before_truncate":
        cfg = _cfg(cfgm, tmp)
        live = _boot(pkg, cfg, data)
        twin = _boot(pkg, _cfg(cfgm, tmp, wal=None), data)
        pre = _traffic(pts, N0, 40, 5000)
        _apply(live, pre)
        _apply(twin, pre)
        live.save(str(tmp / "snap"))
        # A save flushes the insert buffer; the twin flushes at the same
        # point, so both build their RW tier from the same chunks.
        twin._flush_inserts()
        post = _traffic(pts, N0 + 40, 30, 6000) + [("d", 5003), ("d", 6002)]
        _apply(live, post)
        _apply(twin, post)
        crashed = _empty(pkg, cfg)
        n = crashed.recover(str(tmp / "snap"))
        assert {5003, 6002} <= crashed.deleted_ext
        expect = len(post)
    elif case == "empty_suffix":
        cfg = _cfg(cfgm, tmp)
        live = _boot(pkg, cfg, data)
        _apply(live, _traffic(pts, N0, 40, 5000))
        live.save(str(tmp / "snap"))
        crashed, twin = _empty(pkg, cfg), live
        n = crashed.recover(str(tmp / "snap"))
        expect = 0
    elif case == "stale_offset_same_epoch":
        cfg = _cfg(cfgm, tmp)
        live = _boot(pkg, cfg, data)
        _apply(live, _traffic(pts, N0, 40, 5000))
        live.save(str(tmp / "snap"))          # records offset O1, epoch 0
        live.wal.close()
        wal_path = os.path.join(cfg.wal_dir, "wal.bin")
        twal.truncate(wal_path, D, 0)         # same epoch, shorter log
        assert twal.log_epoch(wal_path) == 0
        sysm = _MOD[pkg][1].FreshDiskANN
        kw = {"device": "cpu"} if pkg == PORT else {}
        live2 = sysm.load(str(tmp / "snap"), cfg, **kw)
        post = _traffic(pts, N0 + 40, 10, 8000)
        _apply(live2, post)
        twin = sysm.load(str(tmp / "snap"), _cfg(cfgm, tmp, wal=None), **kw)
        _apply(twin, post)
        crashed = _empty(pkg, cfg)
        n = crashed.recover(str(tmp / "snap"))
        live2.wal.close()
        expect = len(post)
    else:                                     # after a merge's truncation
        store = dict(storage_dir=str(tmp / "store"), adjacency_cache_mb=0)
        kw = store if case == "layout_snapshot" else {}
        cfg = _cfg(cfgm, tmp, snaps="snaps", merge_threshold=64, **kw)
        live = _boot(pkg, cfg, data)
        twin = _boot(pkg, _cfg(cfgm, tmp, wal=None, merge_threshold=64),
                     data)
        pre = _traffic(pts, N0, 80, 5000)     # crosses the threshold
        _apply(live, pre)
        _apply(twin, pre)
        assert live.stats.merges == 1
        snap = live.latest_snapshot()
        assert snap and os.path.isdir(snap)
        assert twal.log_epoch(os.path.join(cfg.wal_dir, "wal.bin")) == 1
        assert (os.path.isdir(os.path.join(snap, "layout"))
                == (case == "layout_snapshot"))
        assert (os.path.exists(os.path.join(snap, "lti.npz"))
                == (case != "layout_snapshot"))
        post = _traffic(pts, N0 + 80, 25, 7000) + [("d", 7001), ("d", 4)]
        _apply(live, post)
        _apply(twin, post)
        _close(live)
        crashed = _empty(pkg, cfg)
        n = crashed.recover()                 # the newest merge snapshot
        # The fresh epoch: the 16 inserts after the merge, then post.
        expect = (80 - 64) + len(post)
    return crashed, twin, n, expect


CASES = ["before_truncate", "after_truncate", "stale_offset_same_epoch",
         "empty_suffix", "layout_snapshot"]


@pytest.mark.parametrize("case", CASES)
def test_recovery_twins_and_matches_reference(case, tmp_path, data):
    qs = data[-1]
    crashed, twin, n, expect = _run_case(case, PORT, tmp_path, data)
    assert n == expect                        # the suffix only
    _assert_twinned(crashed, twin, qs)
    j_crashed, _, j_n, _ = _run_case(case, REF, tmp_path, data)
    assert j_n == n
    for a, b in zip(_search(j_crashed, qs), _search(crashed, qs)):
        np.testing.assert_array_equal(a, b)
    assert crashed.deleted_ext == j_crashed.deleted_ext
    if case == "layout_snapshot":
        # The recovered system re-synced its layout: the disk read path
        # equals the in-memory one.
        for a, b in zip(crashed.search_disk(qs, k=5), _search(crashed, qs)):
            np.testing.assert_array_equal(a, b)
    _close(crashed, j_crashed)


def test_no_truncate_without_snapshot_dir(tmp_path, data):
    """Without snapshot_dir a merge keeps the whole log: a full replay
    over a fresh bootstrap reconstructs the stream."""
    pts, *_, qs = data
    cfg = _cfg(tconfig, tmp_path, merge_threshold=64)
    live = _boot(PORT, cfg, data)
    _apply(live, _traffic(pts, N0, 80, 5000))
    assert live.stats.merges == 1
    wal_path = os.path.join(cfg.wal_dir, "wal.bin")
    assert twal.log_epoch(wal_path) == 0
    live.wal.close()
    crashed = _boot(PORT, _cfg(tconfig, tmp_path), data)
    assert crashed.recover() == 80
    twin = _boot(PORT, _cfg(tconfig, tmp_path, wal=None), data)
    _apply(twin, _traffic(pts, N0, 80, 5000))
    _assert_twinned(crashed, twin, qs)
    assert crashed.size == N0 + 80
    crashed.wal.close()


def test_wal_files_identical_and_replayed_by_either(tmp_path, data):
    """The same operations give byte-identical logs in both packages, and
    each package recovers from the other's log."""
    pts, *_, qs = data
    ops_ = (_traffic(pts, N0, 50, 5000) + [("d", 5007), ("d", 3)]
            + _traffic(pts, N0 + 50, 10, 6000))
    live = {}
    for pkg in (PORT, REF):
        live[pkg] = _boot(pkg, _cfg(_MOD[pkg][0], tmp_path / pkg), data)
        _apply(live[pkg], ops_)
        live[pkg].wal.close()
    paths = {pkg: os.path.join(live[pkg].cfg.wal_dir, "wal.bin")
             for pkg in live}
    with open(paths[PORT], "rb") as a, open(paths[REF], "rb") as b:
        assert a.read() == b.read()
    want = [(op, e, None if v is None else v.tolist())
            for op, e, v in jwal.replay(paths[REF])]
    assert [(op, e, None if v is None else v.tolist())
            for op, e, v in twal.replay(paths[REF])] == want
    for pkg, other in ((PORT, REF), (REF, PORT)):
        crashed = _boot(pkg, _cfg(_MOD[pkg][0], tmp_path / other), data)
        assert crashed.recover() == len(ops_)
        for a, b in zip(_search(crashed, qs), _search(live[pkg], qs)):
            np.testing.assert_array_equal(a, b)
        assert crashed.size == live[pkg].size
        crashed.wal.close()


@pytest.mark.parametrize("storage", [False, True], ids=["npz", "layout"])
def test_snapshot_loaded_by_the_other_package(tmp_path, data, storage):
    """A snapshot written by either package (``lti.npz`` or ``layout/``)
    loads in the other and serves the same results."""
    pts, *_, qs = data
    ops_ = (_traffic(pts, N0, 70, 5000) + [("d", 5007), ("d", 3)])
    live = {}
    for pkg in (PORT, REF):
        kw = (dict(storage_dir=str(tmp_path / pkg / "store"))
              if storage else {})
        live[pkg] = _boot(pkg, _cfg(_MOD[pkg][0], tmp_path / pkg, wal=None,
                                    **kw), data)
        _apply(live[pkg], ops_)
        live[pkg].save(str(tmp_path / pkg / "snap"))
    assert os.path.isdir(str(tmp_path / PORT / "snap" / "layout")) == storage
    for pkg, other in ((PORT, REF), (REF, PORT)):
        cfg = _cfg(_MOD[pkg][0], tmp_path / f"{pkg}-load", wal=None)
        kw = {"device": "cpu"} if pkg == PORT else {}
        loaded = _MOD[pkg][1].FreshDiskANN.load(
            str(tmp_path / other / "snap"), cfg, **kw)
        assert loaded.size == live[other].size
        assert loaded.deleted_ext == live[other].deleted_ext
        assert len(loaded.ro) == len(live[other].ro) > 0
        np.testing.assert_array_equal(loaded.lti_ext_ids,
                                      live[other].lti_ext_ids)
        for a, b in zip(_search(loaded, qs), _search(live[other], qs)):
            np.testing.assert_array_equal(a, b)
    _close(*live.values())




# ------------------------------------------------------- labelled matrix

def _label_map(sys_):
    """ext id -> (tenant, bits) over every tier, deleted ids left out: the
    durability ground truth, whichever tier holds a copy."""
    sys_._flush_inserts()
    out = {}
    tiers = [(sys_.lti_ext_ids, sys_.lti_labels)]
    tiers += [(t.ext_ids, t.labels) for t in [sys_.rw] + list(sys_.ro)]
    for ext, tab in tiers:
        for slot in np.nonzero(ext >= 0)[0]:
            e = int(ext[slot])
            if e not in sys_.deleted_ext:
                out[e] = (int(tab.tenant[slot]),
                          tuple(tab.bits[slot].tolist()))
    return out


_SPECS = (dict(tenant=1), dict(all_of=(2,)), dict(all_of=(0,), tenant=0),
          dict(any_of=(1, 3)))


def _filtered(sys_, qs, mod):
    return [sys_.search_batch(qs, k=5, L=48, filter=mod.FilterSpec(**kw))
            for kw in _SPECS]


def _run_labelled(case, pkg, tmp, data):
    """One labelled crash case for one package -> (recovered, twin,
    records replayed, expected count)."""
    pts = data[0]
    tmp = tmp / pkg
    cfgm, _ = _MOD[pkg]
    lw = dict(filter_words=1)
    if case == "wal_replay":
        cfg = _cfg(cfgm, tmp, **lw)
        live = _boot(pkg, cfg, data, labelled=True)
        twin = _boot(pkg, _cfg(cfgm, tmp, wal=None, **lw), data,
                     labelled=True)
        pre = _labelled_traffic(pts, N0, 40, 5000)
        _apply(live, pre)
        _apply(twin, pre)
        live.save(str(tmp / "snap"))
        twin._flush_inserts()
        post = _labelled_traffic(pts, N0 + 40, 30, 6000) + [("d", 5003)]
        _apply(live, post)
        _apply(twin, post)
        crashed = _empty(pkg, cfg)
        n = crashed.recover(str(tmp / "snap"))
        expect = len(post)
    else:                                     # after a merge's truncation
        store = dict(storage_dir=str(tmp / "store"), adjacency_cache_mb=0)
        kw = dict(lw, **(store if case == "layout" else {}))
        cfg = _cfg(cfgm, tmp, snaps="snaps", merge_threshold=64, **kw)
        live = _boot(pkg, cfg, data, labelled=True)
        twin = _boot(pkg, _cfg(cfgm, tmp, wal=None, merge_threshold=64,
                               **lw), data, labelled=True)
        pre = _labelled_traffic(pts, N0, 80, 5000)
        _apply(live, pre)
        _apply(twin, pre)
        assert live.stats.merges == 1
        post = _labelled_traffic(pts, N0 + 80, 25, 7000) + [
            ("d", 7001), ("d", 4)]
        _apply(live, post)
        _apply(twin, post)
        _close(live)
        crashed = _empty(pkg, cfg)
        n = crashed.recover()
        expect = (80 - 64) + len(post)
    return crashed, twin, n, expect


@pytest.mark.parametrize("case", ["wal_replay", "merge_truncate", "layout"])
def test_labelled_recovery_twins_and_matches_reference(case, tmp_path, data):
    """The labelled crash matrix: op-2 records replay with their bits and
    tenants, merged label tables come back from the snapshot (npz or
    layout); the recovered system holds the twin's label map and the
    reference's label tables and filtered results."""
    qs = data[-1]
    crashed, twin, n, expect = _run_labelled(case, PORT, tmp_path, data)
    assert n == expect
    _assert_twinned(crashed, twin, qs)
    assert _label_map(crashed) == _label_map(twin)
    if case != "wal_replay":
        merged = np.isin(crashed.lti_ext_ids, 5000 + np.arange(64))
        assert merged.any() and (crashed.lti_labels.tenant[merged]
                                 != tgraph.NO_TENANT).any()
    j_crashed, _, j_n, _ = _run_labelled(case, REF, tmp_path, data)
    assert j_n == n
    assert _label_map(crashed) == _label_map(j_crashed)
    np.testing.assert_array_equal(crashed.lti_labels.bits,
                                  j_crashed.lti_labels.bits)
    np.testing.assert_array_equal(crashed.lti_labels.tenant,
                                  j_crashed.lti_labels.tenant)
    for a, b in zip(_filtered(crashed, qs, tgraph),
                    _filtered(j_crashed, qs, jgraph)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    if case == "layout":
        # The recovered layout holds the label tables, so the disk lane
        # filters as the in-memory one does (the sequential oracle's rows).
        import dataclasses
        oracle = dataclasses.replace(crashed.cfg, batch_fanout=False)
        for kw in _SPECS:
            spec = tgraph.FilterSpec(**kw)
            got = crashed.search_disk(qs, k=5, L=48, filter=spec)
            crashed.cfg, cfg = oracle, crashed.cfg
            want = crashed.search_batch(qs, k=5, L=48, filter=spec)
            crashed.cfg = cfg
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
    _close(crashed, j_crashed)


def test_labelled_wal_identical_and_replayed_by_either(tmp_path, data):
    """Labelled and label-free inserts and deletes give byte-identical
    logs in both packages (op-2 records included); each package recovers
    the other's log into the same label map and filtered results."""
    pts, *_, qs = data
    ops_ = (_labelled_traffic(pts, N0, 50, 5000) + [("d", 5007), ("d", 3)]
            + _traffic(pts, N0 + 50, 10, 6000))
    live = {}
    for pkg in (PORT, REF):
        live[pkg] = _boot(pkg, _cfg(_MOD[pkg][0], tmp_path / pkg,
                                    filter_words=1), data, labelled=True)
        _apply(live[pkg], ops_)
        live[pkg].wal.close()
    paths = {pkg: os.path.join(live[pkg].cfg.wal_dir, "wal.bin")
             for pkg in live}
    with open(paths[PORT], "rb") as a, open(paths[REF], "rb") as b:
        assert a.read() == b.read()
    recs = list(twal.replay(paths[REF]))
    assert {op for op, _, _ in recs} == {0, 1, 2}
    for (op, e, v), (jop, je, jv) in zip(recs, jwal.replay(paths[REF])):
        assert (op, e) == (jop, je)
        if op == twal.OP_INSERT_LABELED:
            assert (v.tenant, v.bits.tolist(), v.vec.tolist()) == (
                jv.tenant, jv.bits.tolist(), jv.vec.tolist())
    for pkg, other in ((PORT, REF), (REF, PORT)):
        crashed = _boot(pkg, _cfg(_MOD[pkg][0], tmp_path / other,
                                  filter_words=1), data, labelled=True)
        assert crashed.recover() == len(ops_)
        assert _label_map(crashed) == _label_map(live[pkg])
        mod = tgraph if pkg == PORT else jgraph
        for a, b in zip(_filtered(crashed, qs, mod),
                        _filtered(live[pkg], qs, mod)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        crashed.wal.close()


@pytest.mark.parametrize("storage", [False, True], ids=["npz", "layout"])
def test_labelled_snapshot_loaded_by_the_other_package(tmp_path, data,
                                                       storage):
    """A labelled snapshot (LTI label tables in ``lti.npz`` or the layout's
    ``meta.npz``, temps as 5-tuples) written by either package loads in
    the other with equal label tables and filtered results; the port's
    live layout is read by the reference's ``open_layout`` with the LTI's
    tables."""
    from repro.storage.layout import open_layout as jopen
    pts, *_, qs = data
    ops_ = (_labelled_traffic(pts, N0, 70, 5000) + [("d", 5007), ("d", 3)])
    live = {}
    for pkg in (PORT, REF):
        kw = (dict(storage_dir=str(tmp_path / pkg / "store"))
              if storage else {})
        live[pkg] = _boot(pkg, _cfg(_MOD[pkg][0], tmp_path / pkg, wal=None,
                                    filter_words=1, **kw), data,
                          labelled=True)
        _apply(live[pkg], ops_)
        live[pkg].save(str(tmp_path / pkg / "snap"))
    if storage:
        lay = jopen(live[PORT]._storage_path())
        np.testing.assert_array_equal(lay.label_bits,
                                      live[PORT].lti_labels.bits)
        np.testing.assert_array_equal(lay.label_tenant,
                                      live[PORT].lti_labels.tenant)
        lay.close()
    for pkg, other in ((PORT, REF), (REF, PORT)):
        cfg = _cfg(_MOD[pkg][0], tmp_path / f"{pkg}-load", wal=None,
                   filter_words=1)
        kw = {"device": "cpu"} if pkg == PORT else {}
        loaded = _MOD[pkg][1].FreshDiskANN.load(
            str(tmp_path / other / "snap"), cfg, **kw)
        assert _label_map(loaded) == _label_map(live[other])
        np.testing.assert_array_equal(loaded.lti_labels.tenant,
                                      live[other].lti_labels.tenant)
        assert len(loaded.ro) == len(live[other].ro) > 0
        for a, b in zip(loaded.ro, live[other].ro):
            np.testing.assert_array_equal(a.labels.bits, b.labels.bits)
        mods = (tgraph if pkg == PORT else jgraph,
                tgraph if other == PORT else jgraph)
        for a, b in zip(_filtered(loaded, qs, mods[0]),
                        _filtered(live[other], qs, mods[1])):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    _close(*live.values())


def test_label_free_snapshot_loads_with_filter_words(tmp_path, data):
    """A label-free reference snapshot (historical 3-tuple temps, no label
    tables) loads under ``filter_words=1`` with no labels and no tenants:
    a label filter then matches nothing, the unfiltered search is the
    snapshot's."""
    import pickle
    pts, *_, qs = data
    ref = _boot(REF, _cfg(jconfig, tmp_path, wal=None), data)
    _apply(ref, _traffic(pts, N0, 70, 5000))
    ref.save(str(tmp_path / "snap"))
    with open(tmp_path / "snap" / "temps.pkl", "rb") as f:
        temps = pickle.load(f)
    with open(tmp_path / "snap" / "temps.pkl", "wb") as f:
        pickle.dump([t[:3] for t in temps], f)
    z = dict(np.load(tmp_path / "snap" / "lti.npz"))
    del z["label_bits"], z["label_tenant"]
    np.savez_compressed(tmp_path / "snap" / "lti.npz", **z)
    port = tsystem.FreshDiskANN.load(
        str(tmp_path / "snap"), _cfg(tconfig, tmp_path, wal=None,
                                     filter_words=1), device="cpu")
    assert port.lti_labels.n_words == 1
    assert (port.lti_labels.tenant == tgraph.NO_TENANT).all()
    assert all((t.labels.tenant == tgraph.NO_TENANT).all()
               for t in port.ro + [port.rw])
    for a, b in zip(_search(port, qs), _search(ref, qs)):
        np.testing.assert_array_equal(a, b)
    ids, _ = port.search_batch(qs, k=5, filter=tgraph.FilterSpec(tenant=0))
    assert (ids == -1).all()
