"""The slice as a whole: ``FreshDiskANN`` in the port against the reference.

Both systems start from the same LTI (built by the reference, carried
across with ``repro_torch.convert``) and take the same stream of
operations: streaming inserts with a small ``ro_snapshot_points`` (so the
RW tier rolls over into RO snapshots), deletes of LTI, RO and RW residents
and of a buffered point, a re-insert, and ``search_batch`` with a ragged
request over ``batch_queries`` chunks.

Integer fixture: external ids and distances are equal.  Gaussian fixture:
5-recall@5 within 0.01.  Also: every knob and call of the reference runs
in the port (the merge, serving and filter knobs; labelled and tenant
inserts, filtered ``search_batch`` and ``search_disk``, held against the
reference in ``tests/test_torch_filtered.py``); reaching
``merge_threshold`` merges; CPU tensors never reach a kernel; the default
device needs CUDA (``convert`` included); and neither the port nor
``chip_smoke.py`` imports ``jax`` or ``repro`` (also checked in a fresh
interpreter by ``tests/test_torch_imports.py``).  The WAL, snapshot and
storage knobs run (``tests/test_torch_storage.py``,
``tests/test_torch_recovery.py``).  The merge itself is held
against the reference in ``tests/test_torch_merge.py``.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

from repro.core import config as jconfig  # noqa: E402
from repro.core import system as jsystem  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import system as tsystem  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
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


def _data(kind):
    g = np.random.default_rng(11)
    n = N0 + 140 + NQ
    if kind == "integer":
        x = g.integers(-3, 4, (n, D)).astype(np.float32)
    else:
        centers = g.standard_normal((8, D)) * 3.0
        x = (centers[g.integers(0, 8, n)]
             + g.standard_normal((n, D))).astype(np.float32)
    return x[:N0], x[N0:N0 + 140], x[N0 + 140:]


def _stream(sys_, new):
    """Inserts (two rollovers at 48 points), deletes across every tier,
    a buffered delete and a re-insert."""
    for i in range(120):
        sys_.insert(1000 + i, new[i])
    for e in (3, 17, 1005, 1050, 1100, 1119):
        sys_.delete(e)
    for i in range(120, 140):
        sys_.insert(1000 + i, new[i])
    sys_.delete(1135)                  # still in the insert buffer
    sys_.insert(17, new[0] + 1.0)      # re-insert revives a deleted id


@pytest.fixture(scope="module", params=["integer", "gaussian"])
def systems(request):
    base, new, qs = _data(request.param)
    ref = jsystem.bootstrap_system(base, np.arange(N0), _cfg(jconfig),
                                   batch=32)
    lti = ref.lti
    port = tsystem.FreshDiskANN(
        _cfg(tconfig),
        lti=convert.lti_state(lti.graph, lti.codes, lti.codebook.centroids,
                              "cpu"),
        lti_ext_ids=convert.ext_table(ref.lti_ext_ids), device="cpu")
    ops.reset_launches()
    for s in (ref, port):
        _stream(s, new)
    return request.param, ref, port, base, new, qs


def test_stream_reaches_every_tier(systems):
    _, ref, port, *_ = systems
    assert len(port.ro) == len(ref.ro) == 2
    assert port.rw.n == ref.rw.n > 0
    assert port.size == ref.size
    assert port.stats.snapshots == ref.stats.snapshots == 2
    assert port.stats.flushes == ref.stats.flushes
    assert (port.stats.flush_backedge_targets
            == ref.stats.flush_backedge_targets)
    for a, b in zip([port.rw] + port.ro, [ref.rw] + ref.ro):
        np.testing.assert_array_equal(a.ext_ids, b.ext_ids)


@pytest.mark.parametrize("W", [1, 4])
def test_search_batch_matches_reference(systems, W):
    kind, ref, port, base, new, qs = systems
    a_ids, a_d = ref.search_batch(qs, k=5, beam_width=W)
    b_ids, b_d = port.search_batch(qs, k=5, beam_width=W)
    assert b_ids.shape == (NQ, 5) and b_ids.dtype == np.int64
    assert port.stats.search_dispatches == ref.stats.search_dispatches
    dead = np.fromiter(port.deleted_ext, np.int64)
    assert not np.isin(b_ids, dead).any()
    if kind == "integer":
        np.testing.assert_array_equal(a_ids, b_ids)
        np.testing.assert_array_equal(a_d, b_d)
    else:
        live_ids = np.concatenate([np.arange(N0), 1000 + np.arange(140)])
        live_vecs = np.concatenate([base, new])
        live_vecs[live_ids == 17] = new[0] + 1.0
        keep = ~np.isin(live_ids, dead)
        live_ids, live_vecs = live_ids[keep], live_vecs[keep]
        d = ((qs[:, None, :] - live_vecs[None]) ** 2).sum(-1)
        gt = live_ids[np.argsort(d, axis=1, kind="stable")[:, :5]]

        def recall(ids):
            return ((ids[:, :, None] == gt[:, None, :]).any(2)
                    & (ids >= 0)).sum(1).mean() / 5

        assert abs(recall(a_ids) - recall(b_ids)) <= 0.01
        assert recall(b_ids) >= 0.8


def test_cpu_path_never_reaches_a_kernel(systems):
    """The whole CPU run -- bootstrap state, stream, searches -- took the
    plain versions: every launch counter is still 0."""
    _, _, port, *_ = systems
    port.search_batch(systems[5][:4], k=3)
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


@pytest.mark.parametrize("knob", [dict(shard_lti=2), dict(autotune_beam=True),
                                  dict(batch_fanout=False)],
                         ids=lambda k: next(iter(k)))
def test_serving_knobs_are_ported(knob):
    """The serving knobs run since the serving slice (held against the
    reference in ``tests/test_torch_serving.py``)."""
    s = tsystem.FreshDiskANN(_cfg(tconfig, **knob), device="cpu")
    ids, _ = s.search_batch(np.zeros((2, D), np.float32), k=3)
    assert ids.shape == (2, 3)
    assert getattr(s.cfg, next(iter(knob))) == next(iter(knob.values()))


@pytest.mark.parametrize("knob", [dict(locality_order=True),
                                  dict(background_merge=True)],
                         ids=lambda k: next(iter(k)))
def test_merge_knobs_are_ported(knob):
    s = tsystem.FreshDiskANN(_cfg(tconfig, **knob), device="cpu")
    assert getattr(s.cfg, next(iter(knob))) is True


@pytest.mark.parametrize("knob", ["wal_dir", "snapshot_dir", "storage_dir"])
def test_storage_knobs_are_ported(knob, tmp_path):
    """The WAL, snapshot and storage knobs run since the storage slice:
    the log and the layout appear on disk at construction."""
    s = tsystem.FreshDiskANN(_cfg(tconfig, **{knob: str(tmp_path / knob)}),
                             device="cpu")
    if knob == "wal_dir":
        assert (tmp_path / knob / "wal.bin").is_file()
        s.wal.close()
    elif knob == "storage_dir":
        assert (tmp_path / knob / "lti" / "topology.bin").is_file()
    assert getattr(s.cfg, knob) == str(tmp_path / knob)


@pytest.mark.parametrize("knob", [dict(filter_words=1),
                                  dict(filter_words=2, tenant_quota=3)],
                         ids=["filter_words", "tenant_quota"])
def test_filter_knobs_are_ported(knob):
    """The filter knobs run since the filters slice: label tables of
    ``filter_words`` words in every tier, and a scheduler with a quota."""
    from repro_torch.serving import BatchScheduler
    s = tsystem.FreshDiskANN(_cfg(tconfig, **knob), device="cpu")
    assert s.lti_labels.n_words == s.rw.labels.n_words == knob["filter_words"]
    assert (s.lti_labels.tenant == -1).all()
    assert BatchScheduler(s, k=3).tenant_quota == knob.get("tenant_quota", 0)


@pytest.mark.parametrize("call", ["insert_labels", "insert_tenant",
                                  "search_batch", "search_disk"])
def test_filter_calls_are_ported(call, tmp_path):
    """Labelled and tenant inserts and filtered searches run (a label past
    ``filter_words`` raises the reference's ValueError)."""
    from repro_torch.core.graph import FilterSpec
    s = tsystem.FreshDiskANN(_cfg(tconfig, filter_words=1,
                                  storage_dir=str(tmp_path / "store")),
                             device="cpu")
    g = np.random.default_rng(1)
    for i in range(20):
        s.insert(i, g.integers(-3, 4, D).astype(np.float32),
                 labels=[i % 3] if call != "insert_tenant" else None,
                 tenant=i % 2 if call != "insert_labels" else None)
    spec = (FilterSpec(all_of=(1,)) if call != "insert_tenant"
            else FilterSpec(tenant=1))
    want = np.array([i for i in range(20)
                     if (i % 3 == 1 if call != "insert_tenant"
                         else i % 2 == 1)])
    q = np.zeros((2, D), np.float32)
    fn = s.search_disk if call == "search_disk" else s.search_batch
    ids, _ = fn(q, k=5, filter=spec)
    assert np.isin(ids[ids >= 0], want).all() and (ids >= 0).all()
    assert s.stats.filtered_searches == 2
    with pytest.raises(ValueError, match="out of range"):
        s.insert(99, q[0], labels=[32])
    s.close_storage()


def test_reaching_merge_threshold_raises():
    """Reaching ``merge_threshold`` raised before StreamingMerge was
    ported; now it merges the RO tiers into the (here empty) LTI."""
    s = tsystem.FreshDiskANN(
        _cfg(tconfig, ro_snapshot_points=16, merge_threshold=32),
        device="cpu")
    g = np.random.default_rng(0)
    for i in range(64):
        s.insert(i, g.integers(-3, 4, D).astype(np.float32))
    assert s.stats.merges == 2 and not s.ro
    assert int(s.lti.graph.active.sum()) == 64 and s.size == 64


def test_empty_system_and_k_over_l():
    s = tsystem.FreshDiskANN(_cfg(tconfig), device="cpu")
    ids, d = s.search_batch(np.zeros((3, D), np.float32), k=4)
    assert (ids == -1).all() and np.isinf(d).all()
    with pytest.raises(ValueError, match="k must be <= L"):
        s.search_batch(np.zeros((1, D), np.float32), k=30)


def test_default_device_needs_cuda():
    """Entry points run on the card unless the caller asks for the CPU;
    with no CUDA they raise a clear error instead of running on the CPU."""
    if torch.cuda.is_available():
        assert tconfig.resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsystem.FreshDiskANN(_cfg(tconfig))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsystem.bootstrap_system(np.zeros((8, D), np.float32), np.arange(8),
                                 _cfg(tconfig))
    fields = {k: np.zeros(v, np.float32) for k, v in (
        ("vectors", (4, D)), ("adjacency", (4, 2)), ("active", 4),
        ("deleted", 4), ("start", ()), ("n_total", ()))}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.graph_state(fields)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lti_state(fields, np.zeros((4, 2), np.uint8),
                          np.zeros((2, 4, D // 2), np.float32))


def test_kernel_enabled_by_device():
    icfg = tconfig.IndexConfig(capacity=8, dim=4)
    assert icfg.kernel_enabled("cuda") is True
    assert icfg.kernel_enabled("cpu") is False
    assert dataclasses.replace(icfg, use_kernel=True).kernel_enabled("cpu")
    with pytest.raises(ValueError):
        dataclasses.replace(icfg, use_kernel=False).kernel_enabled("cuda")


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
