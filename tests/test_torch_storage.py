"""The storage slice in the port against the JAX package.

* The decoupled layout: ``topology.bin`` and ``data.bin`` byte-identical to
  the reference's for the same LTI, ``header.json`` equal as JSON,
  ``meta.npz`` equal array by array, and each package opening the other's
  layout; fixed-stride rows; delta patches that write only what changed.
* ``DiskLTISearcher`` at W 1, 2 and prefetch depth 0, 1, 2 with the cache
  off: ids, dists, hops, cmps, reads and every ``IOStats`` field equal to
  the reference's, and to the port's dense ``search_lti``; with the cache
  on, the conservation law; the staging buffers reused.
* ``gather_rows``' plain version against the reference's Pallas
  ``hbm_gather_rows`` in interpret mode, and ``HBMSource`` beam parity.
* The system with ``storage_dir``: ``search_disk`` equal to the
  reference's and to ``search_batch`` across a merge and a consolidation,
  the same patch counters and the same files on disk; knob changes keep
  the conservation law.

Every fixture is integer-valued (coordinates and PQ codebook), so every
f32 sum is exact and the comparisons are bit for bit.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro import storage as jstorage  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core import index as jmem  # noqa: E402
from repro.core import lti as jlti  # noqa: E402
from repro.core import pq as jpq  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core import system as jsystem  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import storage as tstorage  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import lti as tlti  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core import system as tsystem  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CAP, D, R, M, KSUB, N0, NQ = 384, 16, 8, 4, 16, 300, 24
L = 24


def _icfg(mod, **kw):
    return mod.IndexConfig(capacity=CAP, dim=D, R=R, L_build=16,
                           L_search=L, alpha=1.2, **kw)


def _pq(mod):
    return mod.PQConfig(dim=D, m=M, ksub=KSUB, kmeans_iters=3)


def _table():
    t = np.full(CAP, -1, np.int64)
    t[:N0] = np.arange(N0) + 10_000
    return t


@pytest.fixture(scope="module")
def ltis():
    """The same LTI for both packages (the reference's graph, codes from an
    integer codebook) with three deleted points, and integer queries."""
    g = np.random.default_rng(7)
    pts = g.integers(-3, 4, (N0, D)).astype(np.float32)
    cent = g.integers(-3, 4, (M, KSUB, D // M)).astype(np.float32)
    jg = jmem.build(pts, _icfg(jconfig), batch=32)
    deleted = np.asarray(jg.deleted).copy()
    deleted[[3, 50, 211]] = True
    jg = jg._replace(deleted=jnp.asarray(deleted))
    cb = jpq.PQCodebook(jnp.asarray(cent))
    codes = np.zeros((CAP, M), np.uint8)
    codes[:N0] = np.asarray(jpq.encode(cb, jnp.asarray(pts), _pq(jconfig)))
    jl = jlti.LTIState(jg, jnp.asarray(codes), cb)
    tl = convert.lti_state(jg, codes, cent, "cpu")
    qs = g.integers(-3, 4, (NQ, D)).astype(np.float32)
    return jl, tl, qs


@pytest.fixture(scope="module")
def layouts(ltis, tmp_path_factory):
    """The LTI written by each package: (reference path, port path)."""
    jl, tl, _ = ltis
    root = tmp_path_factory.mktemp("layouts")
    jlti.write_lti_layout(str(root / "ref"), jl, ext_ids=_table()).close()
    tlti.write_lti_layout(str(root / "port"), tl, ext_ids=_table()).close()
    return str(root / "ref"), str(root / "port")


def _read(path, name):
    with open(os.path.join(path, name), "rb") as f:
        return f.read()


def _assert_same_files(a, b):
    """topology.bin and data.bin byte-identical, header.json equal as
    JSON, meta.npz equal array by array (np.savez stamps zip times)."""
    for name in ("topology.bin", "data.bin"):
        assert _read(a, name) == _read(b, name), name
    assert (json.loads(_read(a, "header.json"))
            == json.loads(_read(b, "header.json")))
    with np.load(os.path.join(a, "meta.npz")) as ma, \
            np.load(os.path.join(b, "meta.npz")) as mb:
        assert sorted(ma.files) == sorted(mb.files)
        for k in ma.files:
            assert ma[k].dtype == mb[k].dtype, k
            np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


# ----------------------------------------------------------- layout on disk
def test_layout_files_match_reference(layouts):
    _assert_same_files(*layouts)


def test_port_opens_reference_layout(ltis, layouts):
    jl, _, _ = ltis
    lay = tstorage.open_layout(layouts[0])
    got = convert.lti_to_numpy(lay.lti_state("cpu"))
    for k in convert.GRAPH_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jl.graph,
                                                                 k)), k)
    np.testing.assert_array_equal(got["codes"], np.asarray(jl.codes))
    np.testing.assert_array_equal(got["centroids"],
                                  np.asarray(jl.codebook.centroids))
    np.testing.assert_array_equal(lay.ext_ids, _table())
    lay.close()
    twin = tlti.lti_from_layout(layouts[0], device="cpu")
    assert torch.equal(twin.graph.adjacency, tlti.lti_from_layout(
        layouts[1], device="cpu").graph.adjacency)


def test_reference_opens_port_layout(ltis, layouts):
    _, tl, _ = ltis
    want = convert.lti_to_numpy(tl)
    lay = jstorage.open_layout(layouts[1])
    got = lay.lti_state()
    for k in convert.GRAPH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got.graph, k)),
                                      want[k], k)
    np.testing.assert_array_equal(np.asarray(got.codes), want["codes"])
    np.testing.assert_array_equal(lay.ext_ids, _table())
    lay.close()


def test_topology_fixed_stride(layouts):
    """Row i of topology.bin is exactly bytes [i*R*4, (i+1)*R*4)."""
    lay = tstorage.open_layout(layouts[1])
    raw = np.fromfile(os.path.join(lay.path, "topology.bin"), np.int32)
    for i in (0, int(lay.start), CAP - 1):
        np.testing.assert_array_equal(raw[i * R:(i + 1) * R],
                                      np.asarray(lay.adjacency[i]))
    lay.close()


# ------------------------------------------------- disk == dense bit-parity
@pytest.fixture(scope="module")
def dense(ltis):
    """The port's in-memory engine per W: search_lti's tuple + n_reads."""
    _, tl, qs = ltis
    g = tl.graph
    q = torch.from_numpy(qs)
    out = {}
    for W in (1, 2):
        ids, d, hops, cmps = tlti.search_lti(tl, q, _icfg(tconfig), k=5, L=L,
                                             beam_width=W)
        res = tsearch.beam_search(
            g.adjacency, g.active, g.start, q,
            tsearch.PQBackend(tl.codes, tl.codebook), L=L,
            max_visits=_icfg(tconfig).visits_bound(L), beam_width=W)
        out[W] = tuple(x.numpy() for x in (ids, d, hops, cmps,
                                            res.n_reads))
    return out


@pytest.mark.parametrize("W", (1, 2))
@pytest.mark.parametrize("depth", (0, 1, 2))
def test_disk_searcher_matches_reference_and_dense(ltis, layouts, dense, W,
                                                   depth):
    """Cache off: ids, dists, hops, cmps and n_reads equal the
    reference's disk searcher and the port's dense engine at every
    prefetch depth, and so does every IOStats counter."""
    _, _, qs = ltis
    js = jstorage.DiskLTISearcher(jstorage.open_layout(layouts[0]),
                                  _icfg(jconfig), cache_mb=0,
                                  prefetch_depth=depth)
    ts = tstorage.DiskLTISearcher(tstorage.open_layout(layouts[1]),
                                  _icfg(tconfig), cache_mb=0,
                                  prefetch_depth=depth, device="cpu")
    try:
        want = [np.asarray(x) for x in js.search(qs, k=5, L=L,
                                                 beam_width=W)]
        got = [x.numpy() for x in ts.search(qs, k=5, L=L, beam_width=W)]
        for a, b, c, name in zip(want, got, dense[W],
                                 ("ids", "dists", "hops", "cmps", "reads")):
            np.testing.assert_array_equal(a, b, err_msg=name)
            np.testing.assert_array_equal(b, c, err_msg=name)
        assert ts.stats.snapshot() == js.stats.snapshot()
        st = ts.stats
        assert st.cache_hits == 0
        assert st.demand_reads + st.prefetch_hits == st.rows_requested
        if depth:
            assert st.prefetch_hits > 0
    finally:
        js.close()
        ts.close()


@pytest.mark.parametrize("depth", (0, 1))
def test_cache_conservation_law(ltis, layouts, dense, depth):
    """Cache on: every requested row is a file read or a cache hit, and
    reads + hits equals the dense engine's n_reads."""
    _, _, qs = ltis
    ids_d, d_d, _, _, reads_d = dense[2]
    s = tstorage.DiskLTISearcher(tstorage.open_layout(layouts[1]),
                                 _icfg(tconfig), cache_mb=4,
                                 prefetch_depth=depth, device="cpu")
    try:
        ids, d, _, _, reads = s.search(qs, k=5, L=L, beam_width=2)
        np.testing.assert_array_equal(ids.numpy(), ids_d)
        np.testing.assert_array_equal(d.numpy(), d_d)
        st = s.stats
        assert st.cache_hits > 0
        assert (st.demand_reads + st.prefetch_hits + st.cache_hits
                == st.rows_requested == int(reads_d.sum()))
        assert int(reads.sum()) + st.cache_hits == int(reads_d.sum())
    finally:
        s.close()


def test_n_reads_dense_counts_visits(ltis):
    """Dense sources fetch every expanded row: reads == visits, and at
    W 1 one row per round, so reads == hops."""
    _, tl, qs = ltis
    g = tl.graph
    res = tsearch.beam_search(
        g.adjacency, g.active, g.start, torch.from_numpy(qs),
        tsearch.FullPrecisionBackend(g.vectors), L=L,
        max_visits=_icfg(tconfig).visits_bound(L), beam_width=1)
    assert torch.equal(res.n_reads, (res.visited >= 0).sum(1).int())
    assert torch.equal(res.n_reads, res.n_hops)


def test_staging_buffer_reuse(ltis, layouts):
    """After a warm-up search the two staging buffers keep their identity
    and ``allocations`` stays put (the worker asserts every fill lands in
    an owned buffer, so a dead worker would show)."""
    _, _, qs = ltis
    s = tstorage.DiskLTISearcher(tstorage.open_layout(layouts[1]),
                                 _icfg(tconfig), cache_mb=0,
                                 prefetch_depth=2, device="cpu")
    try:
        s.search(qs, k=5, L=L, beam_width=2)
        pf = s.reader.prefetcher
        a0 = pf.allocations
        ident = [id(b) for b in pf.staging_buffers()]
        for _ in range(3):
            s.search(qs, k=5, L=L, beam_width=2)
        assert pf.allocations == a0
        assert [id(b) for b in pf.staging_buffers()] == ident
        assert pf._thread.is_alive()
    finally:
        s.close()


# ----------------------------------------------------------- delta patches
def _patch_both(ltis, tmp_path, change):
    """Apply the same adjacency change through both packages' patch_layout
    on copies of the same LTI; returns (ref stats, port stats, paths)."""
    jl, tl, _ = ltis
    adj = np.asarray(jl.graph.adjacency).copy()
    change(adj)
    jlti.write_lti_layout(str(tmp_path / "ref"), jl).close()
    tlti.write_lti_layout(str(tmp_path / "port"), tl).close()
    jps = jstorage.patch_layout(
        str(tmp_path / "ref"),
        jl.graph._replace(adjacency=jnp.asarray(adj)), codes=jl.codes)
    tps = tstorage.patch_layout(
        str(tmp_path / "port"),
        tl.graph._replace(adjacency=torch.from_numpy(adj)), codes=tl.codes)
    return jps, tps, (str(tmp_path / "ref"), str(tmp_path / "port")), adj


def test_patch_topology_only_writes_no_vector_bytes(ltis, tmp_path):
    """A topology-only update rewrites exactly the changed rows and zero
    vector or code bytes, with the reference's counters and files."""
    def change(adj):
        adj[7] = adj[7][::-1].copy()
        adj[123, 0] = -1

    jps, tps, paths, adj = _patch_both(ltis, tmp_path, change)
    assert dataclasses.asdict(tps) == dataclasses.asdict(jps)
    assert tps.adj_rows == 2 and tps.vec_rows == 0 and tps.code_rows == 0
    lay = tstorage.open_layout(paths[1])
    assert tps.bytes_written == 2 * lay.row_bytes
    assert tps.adj_blocks == np.unique(np.asarray([7, 123])
                                       // lay.block_rows).size
    np.testing.assert_array_equal(np.asarray(lay.adjacency), adj)
    assert lay.generation == 1
    lay.close()
    _assert_same_files(*paths)


def test_patch_noop_writes_nothing(ltis, tmp_path):
    jps, tps, paths, _ = _patch_both(ltis, tmp_path, lambda adj: None)
    assert dataclasses.asdict(tps) == dataclasses.asdict(jps)
    assert tps.adj_rows == tps.vec_rows == tps.code_rows == 0
    assert tps.adj_blocks == 0 and tps.bytes_written == 0
    _assert_same_files(*paths)


# -------------------------------------------- gather_rows and HBMSource
def test_gather_rows_plain_matches_pallas_kernel(ltis):
    """The plain version of ``gather_rows`` equals the reference's Pallas
    scalar-prefetch gather in interpret mode (INVALID rows included), for
    the reference's [W] ids and the port's [B, W]; an id past the table
    raises on the CPU."""
    jl, tl, _ = ltis
    ids = np.array([0, 5, 17, -1, 2, 5, CAP - 1], np.int32)
    want = np.asarray(jstorage.hbm_gather_rows(
        jl.graph.adjacency, jnp.asarray(ids), interpret=True))
    table = tl.graph.adjacency
    got = ops.gather_rows(table, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    ids2 = np.stack([ids, ids[::-1]])
    got2 = tstorage.hbm_gather_rows(table, torch.from_numpy(ids2))
    assert got2.shape == (2, len(ids), R)
    np.testing.assert_array_equal(got2[1].numpy(), want[::-1])
    np.testing.assert_array_equal(
        got2.numpy(), tsearch.DenseSource(table, tl.graph.active).rows(
            torch.from_numpy(ids2)).numpy())
    with pytest.raises(IndexError):
        ops.gather_rows(table, torch.tensor([[1, CAP]], dtype=torch.int32))
    assert ops.LAUNCHES["gather_rows"] == 0


@pytest.mark.parametrize("W", (1, 2))
def test_hbm_source_beam_parity(ltis, W):
    """A beam search through HBMSource equals DenseSource in all seven
    fields, and the reference's HBMSource search."""
    jl, tl, qs = ltis
    g = tl.graph
    kw = dict(L=L, max_visits=_icfg(tconfig).visits_bound(L), beam_width=W)
    q = torch.from_numpy(qs)
    backend = tsearch.PQBackend(tl.codes, tl.codebook)
    want = tsearch.beam_search(g.adjacency, g.active, g.start, q, backend,
                               **kw)
    got = tsearch.beam_search(None, None, g.start, q, backend,
                              source=tstorage.HBMSource(g.adjacency,
                                                        g.active),
                              R=R, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    jg = jl.graph
    ref = jsearch.beam_search(None, None, jg.start, jnp.asarray(qs),
                              jsearch.PQBackend(jl.codes, jl.codebook),
                              source=jstorage.HBMSource(jg.adjacency,
                                                        jg.active),
                              R=R, use_kernel=False, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------ system integration
def _scfg(mod, root, **kw):
    base = dict(index=_icfg(mod), pq=_pq(mod), ro_snapshot_points=32,
                merge_threshold=100_000, temp_capacity=96, insert_batch=16,
                storage_dir=str(root / "store"), prefetch_depth=1,
                adjacency_cache_mb=0)
    base.update(kw)
    return mod.SystemConfig(**base)


def _systems(ltis, tmp_path, **kw):
    jl, tl, _ = ltis
    table = np.full(CAP, -1, np.int64)
    table[:N0] = np.arange(N0)
    # The fixture's deleted flags without a DeleteList: start clean.
    jl = jl._replace(graph=jl.graph._replace(
        deleted=jnp.zeros(CAP, bool)))
    tl = tl._replace(graph=tl.graph._replace(
        deleted=torch.zeros(CAP, dtype=torch.bool)))
    ref_sys = jsystem.FreshDiskANN(_scfg(jconfig, tmp_path / "ref", **kw),
                                   lti=jl, lti_ext_ids=table.copy())
    port = tsystem.FreshDiskANN(_scfg(tconfig, tmp_path / "port", **kw),
                                lti=tl, lti_ext_ids=table.copy(),
                                device="cpu")
    return ref_sys, port


_IO = ("io_rows_read", "io_cache_hits", "io_prefetch_hits", "io_bytes_read",
       "storage_rows_patched", "storage_blocks_patched",
       "storage_bytes_written")


def _same(ref_sys, port, qs):
    want = ref_sys.search_disk(qs, k=5)
    got = port.search_disk(qs, k=5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, port.search_batch(qs, k=5)):
        np.testing.assert_array_equal(a, b)
    for name in _IO:
        assert getattr(port.stats, name) == getattr(ref_sys.stats, name), \
            name
    _assert_same_files(str(ref_sys._storage_path()),
                       str(port._storage_path()))


def test_system_search_disk_matches_reference(ltis, tmp_path):
    """With storage_dir: the layout written at construction, search_disk
    over the RW, RO and disk LTI lanes, a merge's delta patch and a
    consolidation's, against the reference: equal results, IO and patch
    counters and files, and search_disk == search_batch."""
    _, _, qs = ltis
    g = np.random.default_rng(12)
    new = g.integers(-3, 4, (80, D)).astype(np.float32)
    ref_sys, port = _systems(ltis, tmp_path)
    for s in (ref_sys, port):
        for i in range(80):
            s.insert(5000 + i, new[i])
        for e in (1, 7, 5003, 5070):
            s.delete(e)
    assert port.ro and port.rw.n
    _same(ref_sys, port, qs)
    assert port.stats.io_rows_read > 0
    for s in (ref_sys, port):
        s.merge()
    assert port.stats.storage_rows_patched > 0
    _same(ref_sys, port, qs)
    for s in (ref_sys, port):
        for e in (2, 9, 40):
            s.delete(e)
    assert port.consolidate() == ref_sys.consolidate() == 3
    _same(ref_sys, port, qs)
    for s in (ref_sys, port):
        s.close_storage()


def test_system_knob_reconfigure_conservation(ltis, tmp_path):
    """Depth and cache knobs change the read/hit split, never the results:
    io_rows_read + io_cache_hits stays the rows requested."""
    _, _, qs = ltis
    _, port = _systems(ltis, tmp_path, prefetch_depth=0)
    want = port.search_batch(qs, k=5)
    port.search_disk(qs, k=5)
    baseline = port.stats.io_rows_read
    assert baseline > 0 and port.stats.io_cache_hits == 0
    port.cfg = dataclasses.replace(port.cfg, prefetch_depth=2,
                                   adjacency_cache_mb=4)
    port.close_storage()
    r0, c0 = port.stats.io_rows_read, port.stats.io_cache_hits
    got = port.search_disk(qs, k=5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    reads = port.stats.io_rows_read - r0
    hits = port.stats.io_cache_hits - c0
    assert hits > 0 and reads + hits == baseline
    port.close_storage()
