"""The port's delete path against the JAX package.

* The plain versions of the two repair kernels against the reference's
  Pallas kernels in interpret mode, on the reference's own operands
  (``repro.kernels.ops.delete_repair_{fp,sdc}``), and the port's
  gather-fused CPU wrappers against the reference's whole block step.
* Algorithm 4 -- ``consolidate_deletes`` and ``consolidate_deletes_codes``,
  global and local sweeps -- against the reference's ``use_kernel=False``
  engine, with the port's plain block engine and with its kernel wrappers
  on CPU tensors; the naive policies; ``affected_mask``,
  ``repair_cap_overflow`` and the reachability probe.

Tolerances: integer fixtures (integer coordinates and an integer PQ
codebook: every f32 sum is exact in any order) must be bit-identical.
Gaussian fixtures: at least 95 % of the adjacency rows identical (a row
may differ only where an alpha-cover test is a near tie), the entry point
equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import delete as jdel  # noqa: E402
from repro.core import index as jmem  # noqa: E402
from repro.core import pq as jpq  # noqa: E402
from repro.core import reach as jreach  # noqa: E402
from repro.core.config import IndexConfig as JIndexConfig  # noqa: E402
from repro.core.config import PQConfig as JPQConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import delete as tdel  # noqa: E402
from repro_torch.core import index as tmem  # noqa: E402
from repro_torch.core import pq as tpq  # noqa: E402
from repro_torch.core import reach as treach  # noqa: E402
from repro_torch.core.config import IndexConfig  # noqa: E402
from repro_torch.core.prune import check_alpha_rng_rows  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CAP, D, R, M, KSUB, N = 384, 16, 8, 4, 16, 300
KINDS = ["integer", "gaussian"]


def _cfg(cls, **kw):
    return cls(capacity=CAP, dim=D, R=R, L_build=16, L_search=24, alpha=1.2,
               **kw)


def _pq(cls):
    return cls(dim=D, m=M, ksub=KSUB, kmeans_iters=3)


@pytest.fixture(scope="module", params=KINDS)
def graph(request):
    """A reference-built graph of N points, carried to the port, with PQ
    codes from an integer codebook (integer kind) or a trained one."""
    kind = request.param
    g = np.random.default_rng(7)
    if kind == "integer":
        pts = g.integers(-3, 4, (N, D)).astype(np.float32)
        cent = g.integers(-3, 4, (M, KSUB, D // M)).astype(np.float32)
    else:
        centers = g.standard_normal((8, D)) * 3.0
        pts = (centers[g.integers(0, 8, N)]
               + g.standard_normal((N, D))).astype(np.float32)
        cent = np.array(jpq.train_pq(jnp.asarray(pts),
                                     _pq(JPQConfig)).centroids)
    jg = jmem.build(pts, _cfg(JIndexConfig), batch=32)
    codes = np.zeros((CAP, M), np.uint8)
    codes[:N] = np.asarray(jpq.encode(jpq.PQCodebook(jnp.asarray(cent)),
                                      jnp.asarray(pts), _pq(JPQConfig)))
    return kind, pts, jg, convert.graph_state(jg, "cpu"), codes, cent


def _assert_adj(kind, want, got):
    want, got = np.asarray(want), np.asarray(got)
    if kind == "integer":
        np.testing.assert_array_equal(want, got)
    else:
        assert (want == got).all(1).mean() >= 0.95


def _victims(step=9):
    return np.arange(0, N, step).astype(np.int32)


def _tables(cent):
    return (jpq.sdc_tables(jpq.PQCodebook(jnp.asarray(cent))),
            tpq.sdc_tables(tpq.PQCodebook(torch.from_numpy(cent))))


def _block_nodes(tg, deleted):
    """B=8 node ids: repaired nodes, untouched ones and a deleted one."""
    usable = tg.active & ~deleted
    aff = np.nonzero(tdel.affected_mask(tg.adjacency, deleted,
                                        usable).numpy())[0]
    quiet = np.nonzero(~tdel.affected_mask(tg.adjacency, deleted,
                                           usable).numpy()
                       & tg.active.numpy())[0]
    dead = np.nonzero(deleted.numpy())[0]
    return np.concatenate([aff[:5], quiet[:2], dead[:1]]).astype(np.int32)


# ------------------------------------------------------------- kernels
def test_delete_repair_fp_matches_jax_kernel(graph):
    kind, pts, jg, tg, *_ = graph
    deleted = torch.zeros(CAP, dtype=torch.bool)
    deleted[_victims()] = True
    usable = tg.active & ~deleted
    table = tg.vectors
    ids = torch.from_numpy(_block_nodes(tg, deleted))
    operands = ref.repair_operands_fp(tg.adjacency, deleted, usable, table,
                                      ids)
    assert operands[5].shape == (8, R + R * R)
    want = np.asarray(jops.delete_repair_fp(
        *[jnp.asarray(x.numpy()) for x in operands], alpha=1.2, R=R,
        use_kernel=True))
    got = ref.delete_repair_fp_ref(*operands, alpha=1.2, R=R).numpy()
    _assert_adj(kind, want, got)
    # The gather-fused wrapper (CPU: the plain version) against the
    # reference's whole block step.
    block = np.asarray(jdel._repair_block_kernel(
        jg.adjacency, jg.vectors, jnp.asarray(deleted.numpy()),
        jnp.asarray(usable.numpy()), jnp.asarray(ids.numpy()), 1.2, R))
    fused = ops.delete_repair_fp(tg.adjacency, deleted, usable, table, ids,
                                 alpha=1.2, R=R).numpy()
    _assert_adj(kind, block, fused)
    assert (fused[5:] == tg.adjacency[ids[5:].long()].numpy()).all()


@pytest.mark.parametrize("cap", [2, 8])
def test_delete_repair_sdc_matches_jax_kernel(graph, cap):
    kind, pts, jg, tg, codes, cent = graph
    deleted = torch.zeros(CAP, dtype=torch.bool)
    deleted[_victims(5)] = True
    usable = tg.active & ~deleted
    jt, tt = _tables(cent)
    codes_t = torch.from_numpy(codes)
    ids = torch.from_numpy(_block_nodes(tg, deleted))
    operands = ref.repair_operands_sdc(tg.adjacency, deleted, usable,
                                       codes_t, tt, ids, cap)
    assert operands[5].shape == (8, R + cap * R)
    want = np.asarray(jops.delete_repair_sdc(
        *[jnp.asarray(x.numpy()) for x in operands], alpha=1.2, R=R,
        use_kernel=True))
    got = ref.delete_repair_sdc_ref(*operands, alpha=1.2, R=R).numpy()
    _assert_adj(kind, want, got)
    block = np.asarray(jdel._repair_block_codes_kernel(
        jg.adjacency, jnp.asarray(codes), jt, jnp.asarray(deleted.numpy()),
        jnp.asarray(usable.numpy()), jnp.asarray(ids.numpy()), 1.2, R, cap))
    fused = ops.delete_repair_sdc(tg.adjacency, deleted, usable, codes_t, tt,
                                  ids, alpha=1.2, R=R, cap=cap).numpy()
    _assert_adj(kind, block, fused)


def test_repair_wrappers_check_operands(graph):
    _, _, _, tg, codes, cent = graph
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.delete_repair_fp(tg.adjacency, tg.deleted, tg.active,
                             tg.vectors, ids.long(), alpha=1.2, R=R)
    with pytest.raises(ValueError):
        ops.delete_repair_fp(tg.adjacency, tg.deleted, tg.active,
                             tg.vectors, ids, alpha=1.2, R=R + 1)
    with pytest.raises(ValueError):
        ops.delete_repair_sdc(tg.adjacency, tg.deleted, tg.active,
                              torch.from_numpy(codes), _tables(cent)[1], ids,
                              alpha=1.2, R=R, cap=R + 1)


# ------------------------------------------------------------ Algorithm 4
@pytest.mark.parametrize("mode", ["global", "local"])
def test_consolidate_matches_reference(graph, mode):
    kind, pts, jg, tg, *_ = graph
    v = _victims()
    want = jdel.consolidate_deletes(jdel.delete(jg, jnp.asarray(v)),
                                    _cfg(JIndexConfig, use_kernel=False),
                                    block=64, mode=mode)
    gd = tdel.delete(tg, torch.from_numpy(v))
    assert not tg.deleted.any()                      # input not modified
    for use_kernel in (None, True):                  # plain engine, wrappers
        got = tdel.consolidate_deletes(gd, _cfg(IndexConfig,
                                                use_kernel=use_kernel),
                                       block=64, mode=mode)
        _assert_adj(kind, want.adjacency, got.adjacency.numpy())
        np.testing.assert_array_equal(np.asarray(want.active),
                                      got.active.numpy())
        assert not got.deleted.any()
        assert int(want.start) == int(got.start)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_consolidate_codes_matches_reference(graph, mode):
    kind, pts, jg, tg, codes, cent = graph
    v = _victims(5)
    jt, tt = _tables(cent)
    want = jdel.consolidate_deletes_codes(
        jdel.delete(jg, jnp.asarray(v)), _cfg(JIndexConfig, use_kernel=False),
        jnp.asarray(codes), jt, block=64, cap=2, mode=mode)
    gd = tdel.delete(tg, torch.from_numpy(v))
    for use_kernel in (None, True):
        got = tdel.consolidate_deletes_codes(
            gd, _cfg(IndexConfig, use_kernel=use_kernel),
            torch.from_numpy(codes), tt, block=64, cap=2, mode=mode)
        _assert_adj(kind, want.adjacency, got.adjacency.numpy())
        assert int(want.start) == int(got.start)


def test_affected_mask_and_overflow_match_reference(graph):
    _, _, jg, tg, *_ = graph
    v = _victims(4)
    jd = jdel.delete(jg, jnp.asarray(v))
    td = tdel.delete(tg, torch.from_numpy(v))
    ju, tu = jd.active & ~jd.deleted, td.active & ~td.deleted
    np.testing.assert_array_equal(
        np.asarray(jdel.affected_mask(jd.adjacency, jd.deleted, ju)),
        tdel.affected_mask(td.adjacency, td.deleted, tu).numpy())
    for cap in (1, 2, 8):
        want = int(jdel.repair_cap_overflow(jd.adjacency, jd.deleted, ju,
                                            cap))
        assert tdel.repair_cap_overflow(td.adjacency, td.deleted, tu,
                                        cap) == want
    assert tdel.repair_cap_overflow(td.adjacency, td.deleted, tu, 1) > 0


@pytest.mark.parametrize("policy", ["a", "b"])
def test_naive_policies_match_reference(graph, policy):
    kind, _, jg, tg, *_ = graph
    v = _victims(7)
    jd = jdel.delete(jg, jnp.asarray(v))
    td = tdel.delete(tg, torch.from_numpy(v))
    if policy == "a":
        want, got = (jdel.consolidate_policy_a(jd),
                     tdel.consolidate_policy_a(td))
    else:
        want = jdel.consolidate_policy_b(jd, _cfg(JIndexConfig), block=64)
        got = tdel.consolidate_policy_b(td, _cfg(IndexConfig), block=64)
    _assert_adj(kind, want.adjacency, got.adjacency.numpy())
    assert int(want.start) == int(got.start)


def test_unreachable_fraction_matches_reference(graph):
    kind, _, jg, tg, *_ = graph
    for seed in (0, 1):
        want = jreach.unreachable_fraction(jg, _cfg(JIndexConfig),
                                           samples=24, seed=seed)
        got = treach.unreachable_fraction(tg, _cfg(IndexConfig),
                                          samples=24, seed=seed)
        # The same picks: the unreached counts must agree (the reference's
        # f32 mean rounds the fraction in its last bit).
        assert abs(round(want * 24) - round(got * 24)) <= (
            0 if kind == "integer" else 1)
    empty = tg._replace(active=torch.zeros_like(tg.active))
    assert treach.unreachable_fraction(empty, _cfg(IndexConfig)) == 0.0
    no_start = tg._replace(start=torch.tensor(-1, dtype=torch.int32))
    assert treach.unreachable_fraction(no_start, _cfg(IndexConfig)) == 1.0


# ------------------------------------------------- the port's own contracts
def test_localized_rows_satisfy_alpha_rng(graph):
    """Every row the localized pass repaired is a fresh RobustPrune output
    and satisfies the alpha-RNG invariant."""
    _, _, _, tg, *_ = graph
    cfg = _cfg(IndexConfig)
    gd = tdel.delete(tg, torch.from_numpy(_victims(7)))
    aff = tdel.affected_mask(gd.adjacency, gd.deleted,
                             gd.active & ~gd.deleted).nonzero()[:, 0]
    out = tdel.consolidate_deletes(gd, cfg, mode="local")
    assert check_alpha_rng_rows(out.adjacency, aff.int(), out.vectors,
                                cfg.alpha).all()


def test_affected_mask_covers_changed_rows(graph):
    _, _, _, tg, *_ = graph
    gd = tdel.delete(tg, torch.from_numpy(_victims(13)))
    cover = tdel.affected_mask(gd.adjacency, gd.deleted,
                               gd.active & ~gd.deleted) | gd.deleted
    out = tdel.consolidate_deletes(gd, _cfg(IndexConfig), mode="global")
    changed = (out.adjacency != gd.adjacency).any(1)
    assert not (changed & ~cover).any()
    assert changed.any()


def test_policy_a_repicks_inactive_start(graph):
    _, _, _, tg, *_ = graph
    active = tg.active.clone()
    active[tg.start.long()] = False
    out = tdel.consolidate_policy_a(tg._replace(active=active))
    assert int(out.start) != int(tg.start) and bool(out.active[out.start])


@pytest.mark.parametrize("mode", ["global", "local"])
def test_delete_everything_then_reinsert(graph, mode):
    """Deleting every point leaves the sentinel start and empty searches;
    the next insert re-seeds the entry point."""
    _, pts, _, tg, *_ = graph
    cfg = _cfg(IndexConfig)
    gd = tdel.delete(tg, torch.arange(N, dtype=torch.int32))
    out = tdel.consolidate_deletes(gd, cfg, mode=mode)
    assert int(out.start) == -1 and not out.active.any()
    q = torch.from_numpy(pts[:4])
    ids, *_ = tmem.search(out, q, cfg, k=5, L=24)
    assert (ids < 0).all()
    # insert() writes in place: give it its own vectors.
    st = tmem.insert(out._replace(vectors=out.vectors.clone()),
                     torch.arange(16, dtype=torch.int32),
                     torch.from_numpy(pts[:16]), cfg)
    assert int(st.start) >= 0 and bool(st.active[st.start])
    ids, *_ = tmem.search(st, q, cfg, k=3, L=24)
    assert (ids[:, 0] >= 0).all()
