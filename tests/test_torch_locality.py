"""Locality ordering in the port against the JAX package.

The reference draws its medoids with ``jax.random.choice``; the port's
``order_by_medoids`` takes medoid indices, so the parity tests hand it the
reference's (drawn here with the reference's key and weights).  With the
same medoids the permutation, the ordered merge (slots, graph and every
``MergeStats`` field but ``n_prune_rows``) and the capped Delta patch are
bit-identical on integer fixtures; Gaussian orderings are equal too (the
distances to the medoids are the same elementwise sums).  The port's own
contracts mirror ``tests/test_locality.py``: a true permutation,
deterministic per seed, clusters grouped, invalid rows last, and a system
with ``locality_order`` through flushes and a merge.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import config as jconfig  # noqa: E402
from repro.core import index as jmem  # noqa: E402
from repro.core import insert as jins  # noqa: E402
from repro.core import locality as jloc  # noqa: E402
from repro.core import lti as jlti  # noqa: E402
from repro.core import merge as jmerge  # noqa: E402
from repro.core import pq as jpq  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import index as tmem  # noqa: E402
from repro_torch.core import insert as tins  # noqa: E402
from repro_torch.core import locality as tloc  # noqa: E402
from repro_torch.core import lti as tlti  # noqa: E402
from repro_torch.core import merge as tmerge  # noqa: E402
from repro_torch.core import system as tsystem  # noqa: E402

D, M, KSUB = 16, 4, 16


def _clustered(rng, n, n_centers=8, spread=0.2, integer=False):
    centers = rng.standard_normal((n_centers, D)) * 4.0
    which = rng.integers(0, n_centers, n)
    x = centers[which] + spread * rng.standard_normal((n, D))
    if integer:
        x = np.round(x)
    return x.astype(np.float32), which


def ref_medoids(valid, n_clusters, seed):
    """The reference's medoid draw (``locality._locality_order_impl``)."""
    B = len(valid)
    k = max(1, min(n_clusters, B))
    w = jnp.where(jnp.asarray(valid), 1.0, 1e-9)
    return torch.from_numpy(np.asarray(jax.random.choice(
        jax.random.PRNGKey(seed), B, shape=(k,), replace=True,
        p=w / w.sum())).astype(np.int64))


# --------------------------------------------------------------- primitive
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("b", [1, 7, 64, 129])
@pytest.mark.parametrize("seed", [0, 3])
def test_locality_order_matches_reference(integer, b, seed):
    rng = np.random.default_rng(seed + b)
    vecs, _ = _clustered(rng, b, integer=integer)
    valid = rng.random(b) > 0.1
    want = np.asarray(jloc.locality_order(jnp.asarray(vecs),
                                          jnp.asarray(valid), seed=seed))
    got = tloc.locality_order(torch.from_numpy(vecs),
                              torch.from_numpy(valid),
                              medoids=ref_medoids(valid, 16, seed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    # The port's own draw: still a permutation.
    own = tloc.locality_order(torch.from_numpy(vecs), torch.from_numpy(valid),
                              seed=seed).numpy()
    np.testing.assert_array_equal(np.sort(own), np.arange(b))


def test_locality_order_deterministic():
    vecs, _ = _clustered(np.random.default_rng(0), 96)
    v = torch.from_numpy(vecs)
    a = tloc.locality_order(v, seed=5)
    assert torch.equal(a, tloc.locality_order(v, seed=5))
    c = tloc.locality_order(v, seed=6)
    assert torch.equal(torch.sort(c).values, torch.sort(a).values)
    assert not torch.equal(a, c)


def test_draw_medoids_is_biased_to_valid_rows():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 17, 40]] = True
    med = tloc.draw_medoids(valid, 16, seed=2)
    assert med.shape == (16,) and valid[med].all()
    assert tloc.draw_medoids(torch.zeros(5, dtype=torch.bool), 16).shape == (5,)


def test_locality_order_groups_clusters():
    vecs, _ = _clustered(np.random.default_rng(2), 128, n_centers=4,
                         spread=0.05)
    v = torch.from_numpy(vecs)
    valid = torch.ones(128, dtype=torch.bool)
    med = ref_medoids(valid.numpy(), 4, 0)
    perm = tloc.locality_order(v, valid, n_clusters=4, medoids=med)
    spans = tloc.cluster_spans(perm, v, valid, medoids=med)
    arrival = tloc.cluster_spans(torch.arange(128, dtype=torch.int32), v,
                                 valid, medoids=med)
    assert spans <= 3 and spans < arrival
    assert spans == jloc.cluster_spans(jnp.asarray(perm.numpy()),
                                       jnp.asarray(vecs),
                                       jnp.asarray(valid.numpy()),
                                       n_clusters=4, seed=0)


def test_locality_order_invalid_rows_last():
    vecs, _ = _clustered(np.random.default_rng(3), 64)
    valid = np.ones(64, bool)
    bad = [0, 13, 40, 63]
    valid[bad] = False
    perm = tloc.locality_order(torch.from_numpy(vecs),
                               torch.from_numpy(valid), seed=1).numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(64))
    np.testing.assert_array_equal(perm[-len(bad):], bad)
    assert valid[perm[:-len(bad)]].all()


def test_inverse_permutation():
    perm = torch.from_numpy(np.random.default_rng(4).permutation(37).astype(
        np.int32))
    inv = tloc.inverse_permutation(perm)
    assert torch.equal(inv[perm.long()], torch.arange(37, dtype=torch.int32))
    np.testing.assert_array_equal(
        np.asarray(jloc.inverse_permutation(jnp.asarray(perm.numpy()))),
        inv.numpy())


@pytest.mark.parametrize("n", [0, 1, 5, 16, 17, 100, 299])
@pytest.mark.parametrize("kw", [{}, {"cap": 64}, {"floor": 4}])
def test_next_bucket_matches_reference(n, kw):
    assert tloc.next_bucket(n, **kw) == jloc.next_bucket(n, **kw)


# ----------------------------------------------------- capped Delta patch
def test_capped_patch_matches_reference():
    """A Delta patch capped at >= the distinct targets equals the uncapped
    one; a smaller cap processes the lowest targets only, as the
    reference's top-k does."""
    rng = np.random.default_rng(7)
    n, R = 256, 8
    vecs = rng.integers(-3, 4, (n, D)).astype(np.float32)
    adj = rng.integers(0, n, (n, R)).astype(np.int32)
    adj[rng.random((n, R)) < 0.3] = -1
    usable = rng.random(n) > 0.05
    pj = rng.integers(0, n, 256).astype(np.int32)
    pj[rng.random(256) < 0.2] = -1
    pp = np.where(pj >= 0, rng.integers(0, n, 256), -1).astype(np.int32)
    d = int(np.unique(pj[pj >= 0]).size)
    full = None
    for cap in (None, d, d // 2):
        want = np.asarray(jins.apply_back_edges(
            jnp.asarray(adj), jnp.asarray(vecs), jnp.asarray(usable),
            jnp.asarray(pj), jnp.asarray(pp), alpha=1.2, R=R, chunk=64,
            affected_cap=cap))
        got = tins.apply_back_edges(
            torch.from_numpy(adj.copy()), torch.from_numpy(vecs),
            torch.from_numpy(usable), torch.from_numpy(pj),
            torch.from_numpy(pp), alpha=1.2, R=R, chunk=64,
            affected_cap=cap).numpy()
        np.testing.assert_array_equal(want, got)
        if cap is None:
            full = got
        elif cap >= d:
            np.testing.assert_array_equal(full, got)
    assert not np.array_equal(full, got)      # d // 2 left targets out


# ----------------------------------------------------------- ordered merge
@pytest.fixture(scope="module", params=["integer", "gaussian"])
def ordered_setup(request):
    integer = request.param == "integer"
    rng = np.random.default_rng(11)
    cfg = dict(capacity=512, dim=D, R=8, L_build=16, L_search=24, alpha=1.2)
    pq = dict(dim=D, m=M, ksub=KSUB, kmeans_iters=3)
    base, _ = _clustered(rng, 300, integer=integer)
    newp, _ = _clustered(rng, 96, integer=integer)
    cent = (rng.integers(-3, 4, (M, KSUB, D // M)).astype(np.float32)
            if integer else np.array(jpq.train_pq(
                jnp.asarray(base), jconfig.PQConfig(**pq)).centroids))
    jg = jmem.build(base, jconfig.IndexConfig(**cfg), batch=32)
    cb = jpq.PQCodebook(jnp.asarray(cent))
    codes = np.zeros((512, M), np.uint8)
    codes[:300] = np.asarray(jpq.encode(cb, jnp.asarray(base),
                                        jconfig.PQConfig(**pq)))
    jl = jlti.LTIState(jg, jnp.asarray(codes), cb)
    tl = convert.lti_state(jg, codes, cent, "cpu")
    dmask = np.zeros(512, bool)
    dmask[rng.choice(300, 20, replace=False)] = True
    valid = np.ones(96, bool)
    valid[[4, 50]] = False
    return request.param, cfg, pq, jl, tl, base, newp, valid, dmask


@pytest.mark.parametrize("use_sdc", [False, True])
@pytest.mark.parametrize("mode", ["global", "local"])
def test_ordered_merge_matches_reference(ordered_setup, use_sdc, mode):
    kind, cfg, pq, jl, tl, _, newp, valid, dmask = ordered_setup
    seed = 3
    want, ws = jmerge.streaming_merge(
        jl, jnp.asarray(newp), jnp.asarray(valid), jnp.asarray(dmask),
        jconfig.IndexConfig(**cfg, use_kernel=False), jconfig.PQConfig(**pq),
        insert_chunk=32, block=128, use_sdc=use_sdc, repair_mode=mode,
        locality=True, locality_seed=seed)
    got, gs = tmerge.streaming_merge(
        tl, torch.from_numpy(newp), torch.from_numpy(valid),
        torch.from_numpy(dmask), tconfig.IndexConfig(**cfg),
        tconfig.PQConfig(**pq), insert_chunk=32, block=128, use_sdc=use_sdc,
        repair_mode=mode, locality=True,
        locality_medoids=ref_medoids(valid, 16, seed))
    for name in ("n_deleted", "n_inserted", "n_backedge_pairs",
                 "repair_cap_overflows", "n_backedge_targets"):
        assert int(getattr(ws, name)) == getattr(gs, name), name
    np.testing.assert_array_equal(np.asarray(ws.slots), gs.slots.numpy())
    g = convert.lti_to_numpy(got)
    for k in ("vectors", "active", "start", "n_total"):
        np.testing.assert_array_equal(np.asarray(getattr(want.graph, k)),
                                      g[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(want.codes), g["codes"])
    same = (np.asarray(want.graph.adjacency) == g["adjacency"]).all(1)
    assert same.all() if kind == "integer" else same.mean() >= 0.90
    assert 0 < gs.n_prune_rows <= gs.n_backedge_targets


@pytest.fixture(scope="module")
def port_setup():
    """The port alone at the configuration of ``tests/test_locality.py``
    (capacity 2048, R 24, L 32/48, PQ 8 x 32), where recall is high enough
    to compare orderings."""
    rng = np.random.default_rng(11)
    cfg = dict(capacity=2048, dim=D, R=24, L_build=32, L_search=48,
               alpha=1.2)
    pq = dict(dim=D, m=8, ksub=32, kmeans_iters=4)
    base, _ = _clustered(rng, 600)
    lti = tlti.build_lti(base, tconfig.IndexConfig(**cfg),
                         tconfig.PQConfig(**pq), batch=64, device="cpu")
    newp, _ = _clustered(rng, 128)
    dmask = np.zeros(2048, bool)
    dmask[rng.choice(600, 40, replace=False)] = True
    return "gaussian", cfg, pq, None, lti, base, newp, np.ones(128, bool), \
        dmask


def _ordered(setup, locality, seed=0):
    _, cfg, pq, _, tl, _, newp, valid, dmask = setup
    return tmerge.streaming_merge(
        tl, torch.from_numpy(newp), torch.from_numpy(valid),
        torch.from_numpy(dmask), tconfig.IndexConfig(**cfg),
        tconfig.PQConfig(**pq), insert_chunk=32, block=128,
        locality=locality, locality_seed=seed)


def test_ordered_merge_conservation_and_determinism(port_setup):
    _, cfg, _, _, tl, _, newp, valid, dmask = port_setup
    _, s0 = _ordered(port_setup, False)
    m1, s1 = _ordered(port_setup, True, seed=3)
    m2, s2 = _ordered(port_setup, True, seed=3)
    assert s0.n_inserted == s1.n_inserted == int(valid.sum())
    assert s0.n_deleted == s1.n_deleted == int(dmask.sum())
    sl = s1.slots.numpy()
    live = sl[sl >= 0]
    assert np.unique(live).size == live.size == s1.n_inserted
    pre_free = ~tl.graph.active.numpy() | dmask
    assert pre_free[live].all() and m1.graph.active.numpy()[live].all()
    assert torch.equal(m1.graph.adjacency, m2.graph.adjacency)
    assert torch.equal(s1.slots, s2.slots)
    assert s1.n_prune_rows == s2.n_prune_rows


def test_ordered_merge_recall_equivalence(port_setup):
    """Topology differs from arrival order; serving quality must not."""
    _, cfg, _, _, _, _, newp, _, _ = port_setup
    queries, _ = _clustered(np.random.default_rng(13), 32)
    icfg = tconfig.IndexConfig(**cfg)

    def recall(merged):
        g = merged.graph
        live = (g.active & ~g.deleted).numpy()
        vecs = g.vectors.numpy()
        ids, *_ = tmem.search(g, torch.from_numpy(queries), icfg, k=10,
                              L=cfg["L_search"])
        d = ((queries[:, None] - vecs[None]) ** 2).sum(-1)
        d[:, ~live] = np.inf
        gt = np.argsort(d, axis=1, kind="stable")[:, :10]
        return (ids.numpy()[:, :, None] == gt[:, None]).any(2).mean()

    r0 = recall(_ordered(port_setup, False)[0])
    r1 = recall(_ordered(port_setup, True)[0])
    assert r1 >= r0 - 0.05, (r0, r1)


def test_ordered_merge_dirty_block_placement(port_setup):
    """New rows go to 4 KB topology blocks the merge dirties anyway: the
    ordered merge dirties hardly more blocks than arrival order."""
    _, cfg, _, _, tl, *_ = port_setup
    rpb = max(1, 4096 // (cfg["R"] * 4))
    m1, s1 = _ordered(port_setup, True)
    m0, _ = _ordered(port_setup, False)
    d1 = tmerge.adjacency_delta_mask(tl.graph.adjacency, m1.graph.adjacency)
    d0 = tmerge.adjacency_delta_mask(tl.graph.adjacency, m0.graph.adjacency)
    sl = s1.slots.numpy()
    blocks1 = set((np.nonzero(d1.numpy())[0] // rpb).tolist())
    assert set((sl[sl >= 0] // rpb).tolist()) <= blocks1
    assert len(blocks1) <= np.unique(np.nonzero(d0.numpy())[0] // rpb).size + 2


# ------------------------------------------------------------ live system
def test_system_locality_end_to_end():
    rng = np.random.default_rng(17)
    pts, _ = _clustered(rng, 400)
    cfg = tconfig.SystemConfig(
        index=tconfig.IndexConfig(capacity=2048, dim=D, R=24, L_build=32,
                                  L_search=64, alpha=1.2),
        pq=tconfig.PQConfig(dim=D, m=8, ksub=32, kmeans_iters=4),
        ro_snapshot_points=64, merge_threshold=100_000, temp_capacity=256,
        insert_batch=32, locality_order=True)
    s = tsystem.bootstrap_system(pts[:256], np.arange(256), cfg,
                                 device="cpu", batch=32)
    for i in range(96):
        s.insert(1000 + i, pts[256 + i])
    for e in range(8):
        s.delete(e)
    assert s.stats.flushes >= 3 and s.stats.flush_backedge_targets > 0
    ids, _ = s.search(pts[300:301], k=5)
    assert 1000 + 44 in ids
    s.merge()
    assert s.stats.merges == 1 and s.stats.merge_backedge_targets > 0
    assert 0 < s.stats.merge_prune_rows
    ids, _ = s.search(pts[300:301], k=5)
    assert 1000 + 44 in ids
    assert s.size == 256 + 96 - 8
