"""Build and insert: the port's FreshVamana build, batched insert stages,
Delta grouping and ``build_lti`` against the reference.

Integer fixture (exact arithmetic in any order; n = 256 keeps the medoid's
mean dyadic): identical adjacency, start and flags.  Gaussian fixture:
5-recall@5 within 0.01 of the reference's, and rows fresh out of
RobustPrune hold the alpha-RNG invariant.  PQ codes from the reference's
k-means codebook agree on >= 99 % of rows (an encode tie against
non-dyadic centroids may round either way); on an integer codebook they
are equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import index as jidx  # noqa: E402
from repro.core import insert as jins  # noqa: E402
from repro.core import lti as jlti  # noqa: E402
from repro.core.config import IndexConfig as JIndexConfig  # noqa: E402
from repro.core.config import PQConfig as JPQConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.core import insert as tins  # noqa: E402
from repro_torch.core import lti as tlti  # noqa: E402
from repro_torch.core import prune as tprune  # noqa: E402
from repro_torch.core.config import IndexConfig, PQConfig  # noqa: E402

N, D, CAP = 256, 16, 320
KW = dict(capacity=CAP, dim=D, R=8, L_build=16, L_search=24, alpha=1.2)


def _points(kind, n=N, seed=0):
    g = np.random.default_rng(seed)
    if kind == "integer":
        return g.integers(-3, 4, (n, D)).astype(np.float32)
    centers = g.standard_normal((8, D)) * 3.0
    return (centers[g.integers(0, 8, n)]
            + g.standard_normal((n, D))).astype(np.float32)


def _recall(ids, pts, qs, k=5):
    gt = np.argsort(((qs[:, None, :] - pts[None]) ** 2).sum(-1), axis=1,
                    kind="stable")[:, :k]
    hit = (ids[:, :, None] == gt[:, None, :]).any(2) & (ids >= 0)
    return hit.sum(1).mean() / k


@pytest.fixture(scope="module", params=["integer", "gaussian"])
def built(request):
    """(kind, points, reference graph, port graph) at W=4."""
    pts = _points(request.param)
    kw = dict(KW, beam_width=4)
    jg = jidx.build(pts, JIndexConfig(**kw), batch=32)
    tg = tidx.build(pts, IndexConfig(**kw), batch=32, device="cpu")
    return request.param, pts, jg, tg


def test_build_matches_reference(built):
    kind, pts, jg, tg = built
    assert int(jg.start) == int(tg.start)
    if kind == "integer":
        got = convert.graph_to_numpy(tg)
        for name in convert.GRAPH_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                          got[name], err_msg=name)
    else:
        qs = _points(kind, 32, seed=5)
        cfg = dict(KW, beam_width=4)
        a = np.asarray(jidx.search(jg, jnp.asarray(qs), JIndexConfig(**cfg),
                                   k=5, L=24)[0])
        b = tidx.search(tg, torch.from_numpy(qs), IndexConfig(**cfg), k=5,
                        L=24)[0].numpy()
        assert abs(_recall(a, pts, qs) - _recall(b, pts, qs)) <= 0.01


def test_build_w1_matches_reference():
    """The classic single-expansion search drives the build too."""
    pts = _points("integer", seed=3)
    jg = jidx.build(pts, JIndexConfig(**KW), batch=32)
    tg = tidx.build(pts, IndexConfig(**KW), batch=32, device="cpu")
    np.testing.assert_array_equal(np.asarray(jg.adjacency),
                                  tg.adjacency.numpy())
    assert int(jg.start) == int(tg.start)


def test_pruned_rows_hold_alpha_rng(built):
    """Rows fresh out of RobustPrune satisfy the alpha-RNG invariant (raw
    rows may not: Algorithm 2 appends back edges while under R), and the
    port's verdicts equal the reference's."""
    from repro.core.prune import check_alpha_rng_rows as j_check
    kind, pts, jg, tg = built
    usable = tg.active & ~tg.deleted
    ps = torch.arange(0, N, 5, dtype=torch.int32)
    res = tprune.prune_node_batch(tprune.FullPrecisionPrune(tg.vectors), ps,
                                  tg.adjacency[ps.long()], usable,
                                  alpha=1.2, R=8)
    adj = tg.adjacency.clone()
    adj[ps.long()] = res.ids
    ok = tprune.check_alpha_rng_rows(adj, ps, tg.vectors, 1.2)
    assert bool(ok.all())
    raw_t = tprune.check_alpha_rng_rows(tg.adjacency, ps, tg.vectors, 1.2)
    raw_j = j_check(jnp.asarray(tg.adjacency.numpy()), jnp.asarray(ps.numpy()),
                    jnp.asarray(tg.vectors.numpy()), 1.2)
    np.testing.assert_array_equal(raw_t.numpy(), np.asarray(raw_j))
    assert bool(tprune.check_alpha_rng(res.ids[0], tg.vectors[ps[0].long()],
                                       tg.vectors, 1.2))


def test_insert_stages_match_reference(built):
    """insert_edges_stage + insert_apply_delta on a carried graph equal the
    reference's insert, including masked (INVALID) lanes."""
    kind, pts, jg, _ = built
    new = _points(kind, 40, seed=9)
    slots = np.arange(N, N + 40, dtype=np.int32)
    slots[[3, 17]] = -1
    cfg = dict(KW, beam_width=4)
    want = jidx.insert(jg, jnp.asarray(slots), jnp.asarray(new),
                       JIndexConfig(**cfg))
    tg = convert.graph_state(jg, "cpu")
    st, pj, pp = tidx.insert_edges_stage(tg, torch.from_numpy(slots),
                                         torch.from_numpy(new),
                                         IndexConfig(**cfg))
    got = tidx.insert_apply_delta(st, pj, pp, IndexConfig(**cfg))
    if kind == "integer":
        out = convert.graph_to_numpy(got)
        for name in convert.GRAPH_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                          out[name], err_msg=name)
    else:
        # Gaussian: a near-tie may order two candidates differently after
        # another summation order; almost every row must still agree.
        same = (np.asarray(want.adjacency) == got.adjacency.numpy()).all(1)
        assert same.mean() >= 0.95


def test_group_pairs_are_the_reference_rows():
    g = np.random.default_rng(4)
    pj = g.integers(-1, 30, 200).astype(np.int32)
    pp = g.integers(0, 1000, 200).astype(np.int32)
    pp[pj < 0] = -1
    buf_j, cnt_j = jins.group_pairs(jnp.asarray(pj), jnp.asarray(pp), 40, 6)
    tgt, buf, cnt = tins.group_pairs(torch.from_numpy(pj),
                                     torch.from_numpy(pp), 6)
    t = tgt.numpy()
    np.testing.assert_array_equal(t, np.unique(pj[pj >= 0]))
    np.testing.assert_array_equal(np.asarray(buf_j)[t], buf.numpy())
    np.testing.assert_array_equal(np.asarray(cnt_j)[t], cnt.numpy())


def test_back_edge_append_dedupes():
    """A source already in N_out(j), or listed twice, is appended once."""
    R = 4
    adj = torch.full((10, R), -1, dtype=torch.int32)
    adj[1, :3] = torch.tensor([2, 4, 6], dtype=torch.int32)
    vecs = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    usable = torch.ones(10, dtype=torch.bool)
    out = tins.apply_back_edges(adj, vecs, usable,
                                torch.tensor([1, 1, 1], dtype=torch.int32),
                                torch.tensor([2, 8, 8], dtype=torch.int32),
                                alpha=1.2, R=R)
    assert sorted(out[1].tolist()) == [2, 4, 6, 8]
    combine = torch.tensor([[3, 1, 3, -1, 1, 5]])
    assert tins._dedupe_combine(combine).tolist() == [[3, 1, -1, -1, -1, 5]]


def test_build_lti_with_reference_codebook(built):
    """build_lti given the reference's codebook: the same graph (integer
    fixture) and the same codes on >= 99 % of rows."""
    kind, pts, _, _ = built
    pcfg = dict(dim=D, m=4, ksub=16, kmeans_iters=3)
    jl = jlti.build_lti(pts, JIndexConfig(**KW), JPQConfig(**pcfg),
                        batch=32)
    tl = tlti.build_lti(pts, IndexConfig(**KW), PQConfig(**pcfg), batch=32,
                        codebook=jl.codebook, device="cpu")
    np.testing.assert_array_equal(np.asarray(jl.codebook.centroids),
                                  tl.codebook.centroids.numpy())
    same_codes = (np.asarray(jl.codes) == tl.codes.numpy()).all(1).mean()
    if kind == "integer":
        np.testing.assert_array_equal(np.asarray(jl.graph.adjacency),
                                      tl.graph.adjacency.numpy())
        assert int(jl.graph.start) == int(tl.graph.start)
    # The codebook's centroids are k-means means (not dyadic): an encode
    # tie may round either way in another summation order.
    assert same_codes >= 0.99


def test_brute_force_and_recall_match_reference(built):
    kind, pts, _, tg = built
    qs = _points(kind, 16, seed=7)
    mask = np.zeros(CAP, bool)
    mask[:N] = True
    mask[::7] = False
    vecs = tg.vectors.numpy()
    a = np.asarray(jidx.brute_force(jnp.asarray(vecs), jnp.asarray(mask),
                                    jnp.asarray(qs), 5))
    b = tidx.brute_force(tg.vectors, torch.from_numpy(mask),
                         torch.from_numpy(qs), 5).numpy()
    if kind == "integer":
        np.testing.assert_array_equal(a, b)
    else:
        assert (np.sort(a, 1) == np.sort(b, 1)).mean() >= 0.99
    r = float(jidx.recall_at_k(jnp.asarray(b), jnp.asarray(a)))
    assert r == tidx.recall_at_k(torch.from_numpy(b), torch.from_numpy(a.copy()))


def test_pq_matches_reference():
    """encode / decode / lut / adc / sdc_tables on an integer codebook are
    exact; train_pq draws from a torch.Generator (not jax.random), so its
    codebook is held to the reference's quantization error instead."""
    from repro.core import pq as jpq
    from repro_torch.core import pq as tpq
    g = np.random.default_rng(2)
    pts = _points("integer", 200, seed=2)
    cent = g.integers(-3, 4, (4, 16, D // 4)).astype(np.float32)
    jcfg, tcfg = JPQConfig(dim=D, m=4, ksub=16), PQConfig(dim=D, m=4, ksub=16)
    jcb = jpq.PQCodebook(jnp.asarray(cent))
    tcb = tpq.PQCodebook(torch.from_numpy(cent))
    jc = np.asarray(jpq.encode(jcb, jnp.asarray(pts), jcfg))
    tc = tpq.encode(tcb, torch.from_numpy(pts), tcfg)
    np.testing.assert_array_equal(jc, tc.numpy())
    np.testing.assert_array_equal(np.asarray(jpq.decode(jcb, jnp.asarray(jc),
                                                        jcfg)),
                                  tpq.decode(tcb, tc, tcfg).numpy())
    q = pts[:3]
    luts = tpq.lut(tcb, torch.from_numpy(q))
    for b in range(3):
        jl = np.asarray(jpq.lut(jcb, jnp.asarray(q[b])))
        np.testing.assert_array_equal(jl, luts[b].numpy())
        np.testing.assert_array_equal(
            np.asarray(jpq.adc(jnp.asarray(jc), jnp.asarray(jl))),
            tpq.adc(tc, luts[b]).numpy())
    ids = torch.from_numpy(g.integers(-1, 200, (3, 9)).astype(np.int32))
    got = tpq.adc_gather(tc, luts, ids)
    for b in range(3):
        want = np.asarray(jpq.adc_gather(jnp.asarray(jc), jnp.asarray(
            luts[b].numpy()), jnp.asarray(ids[b].numpy())))
        np.testing.assert_array_equal(want, got[b].numpy())
    np.testing.assert_array_equal(np.asarray(jpq.sdc_tables(jcb)),
                                  tpq.sdc_tables(tcb).numpy())

    gauss = _points("gaussian", 256, seed=4)
    kcfg = dict(dim=D, m=4, ksub=16, kmeans_iters=4)

    def mse(decoded):
        return float(((np.asarray(decoded) - gauss) ** 2).sum(1).mean())

    jcb2 = jpq.train_pq(jnp.asarray(gauss), JPQConfig(**kcfg))
    tcb2 = tpq.train_pq(torch.from_numpy(gauss), PQConfig(**kcfg))
    j_err = mse(jpq.decode(jcb2, jpq.encode(jcb2, jnp.asarray(gauss),
                                            JPQConfig(**kcfg)),
                           JPQConfig(**kcfg)))
    t_err = mse(tpq.decode(tcb2, tpq.encode(tcb2, torch.from_numpy(gauss),
                                            PQConfig(**kcfg)),
                           PQConfig(**kcfg)).numpy())
    assert t_err <= 1.15 * j_err


def test_search_tiers_matches_per_tier_search(built):
    """search_tiers over stacked graphs (one padded to the larger capacity)
    equals search on each tier alone."""
    from repro_torch.core.graph import stack_graphs
    kind, pts, _, tg = built
    small = tidx.build(pts[:100], IndexConfig(**dict(KW, capacity=128)),
                       batch=16, device="cpu")
    qs = torch.from_numpy(_points(kind, 8, seed=6))
    cfg = IndexConfig(**KW)
    out = tidx.search_tiers(stack_graphs([small, tg]), qs, cfg, k=5, L=16)
    for t, g_ in enumerate([small, tg]):
        want = tidx.search(g_, qs, cfg, k=5, L=16)
        for a, b in zip(out, want):
            assert torch.equal(a[t], b)
