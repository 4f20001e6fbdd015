"""Beam search and the LTI lane: the port against the reference, on graphs
the reference built and carried across with ``repro_torch.convert``.

Integer fixture (small integer coordinates and an integer codebook, so
every f32 sum is exact in any order): ids, distances and the counters
n_hops, n_cmps and n_reads must be equal.  Gaussian fixture: the
5-recall@5 of the two packages must agree within 0.01.
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
from repro.core import lti as jlti  # noqa: E402
from repro.core import pq as jpq  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.config import IndexConfig as JIndexConfig  # noqa: E402
from repro.core.config import PQConfig as JPQConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tidx  # noqa: E402
from repro_torch.core import lti as tlti  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.config import IndexConfig  # noqa: E402

N, D, CAP, NQ = 256, 16, 320, 24
KW = dict(capacity=CAP, dim=D, R=8, L_build=16, L_search=24, alpha=1.2)


def _data(kind, seed=0):
    g = np.random.default_rng(seed)
    if kind == "integer":
        pts = g.integers(-3, 4, (N, D)).astype(np.float32)
        qs = g.integers(-3, 4, (NQ, D)).astype(np.float32)
    else:
        centers = g.standard_normal((8, D)) * 3.0
        pts = (centers[g.integers(0, 8, N)]
               + g.standard_normal((N, D))).astype(np.float32)
        qs = (centers[g.integers(0, 8, NQ)]
              + g.standard_normal((NQ, D))).astype(np.float32)
    return pts, qs


@pytest.fixture(scope="module", params=["integer", "gaussian"])
def carried(request):
    """(kind, points, queries, reference graph, port copy of it)."""
    pts, qs = _data(request.param)
    jg = jidx.build(pts, JIndexConfig(**KW), batch=32)
    return request.param, pts, qs, jg, convert.graph_state(jg, "cpu")


def _recall(ids, pts, qs, k=5):
    gt = np.argsort(((qs[:, None, :] - pts[None]) ** 2).sum(-1), axis=1,
                    kind="stable")[:, :k]
    hit = (ids[:, :, None] == gt[:, None, :]).any(2) & (ids >= 0)
    return hit.sum(1).mean() / k


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("L", [12, 24])
def test_beam_search_matches_reference(carried, W, L):
    kind, pts, qs, jg, tg = carried
    mv = JIndexConfig(**KW).visits_bound(L)
    jr = jsearch.beam_search(
        jg.adjacency, jg.active, jg.start, jnp.asarray(qs),
        jsearch.FullPrecisionBackend(jg.vectors), L=L, max_visits=mv,
        beam_width=W)
    tr = tsearch.beam_search(
        tg.adjacency, tg.active, tg.start, torch.from_numpy(qs),
        tsearch.FullPrecisionBackend(tg.vectors), L=L, max_visits=mv,
        beam_width=W)
    if kind == "integer":
        for name in tr._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(jr, name)), getattr(tr, name).numpy(),
                err_msg=f"{name} (W={W}, L={L})")
    else:
        cfg, tcfg = JIndexConfig(**KW), IndexConfig(**KW)
        j_ids = np.asarray(jidx.search(jg, jnp.asarray(qs), cfg, k=5, L=L,
                                       beam_width=W)[0])
        t_ids = tidx.search(tg, torch.from_numpy(qs), tcfg, k=5, L=L,
                            beam_width=W)[0].numpy()
        assert abs(_recall(j_ids, pts, qs) - _recall(t_ids, pts, qs)) <= 0.01


def test_search_kernel_numerics_match_reference_kernel_path(carried):
    """use_kernel=True on the CPU: the port's wrappers take their plain
    versions (the kernels' numerics), the reference runs its Pallas
    kernels in interpret mode.  Exact on integer data, recall within 0.01
    on Gaussian data."""
    kind, pts, qs, jg, tg = carried
    kw = dict(KW, beam_width=4, use_kernel=True)
    a = jidx.search(jg, jnp.asarray(qs[:8]), JIndexConfig(**kw), k=5, L=16)
    b = tidx.search(tg, torch.from_numpy(qs[:8]), IndexConfig(**kw), k=5,
                    L=16)
    if kind == "integer":
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    else:
        assert abs(_recall(np.asarray(a[0]), pts, qs[:8])
                   - _recall(b[0].numpy(), pts, qs[:8])) <= 0.01


@pytest.fixture(scope="module")
def carried_lti(carried):
    """The carried graph as an LTI: PQ codes from a codebook that is
    integer-valued on the integer fixture (so ADC sums stay exact) and
    trained by the reference on the Gaussian one, one DeleteList member."""
    kind, pts, qs, jg, _ = carried
    m, ksub = 4, 16
    pcfg = JPQConfig(dim=D, m=m, ksub=ksub, kmeans_iters=4)
    if kind == "integer":
        g = np.random.default_rng(1)
        cent = g.integers(-3, 4, (m, ksub, D // m)).astype(np.float32)
    else:
        cent = np.asarray(jpq.train_pq(jnp.asarray(pts), pcfg).centroids)
    codes = np.zeros((CAP, m), np.uint8)
    codes[:N] = np.asarray(jpq.encode(jpq.PQCodebook(jnp.asarray(cent)),
                                      jnp.asarray(pts), pcfg))
    deleted = np.zeros(CAP, bool)
    deleted[np.asarray(jidx.search(jg, jnp.asarray(qs[:1]),
                                   JIndexConfig(**KW), k=1, L=24)[0])[0]] = True
    jg2 = jg._replace(deleted=jnp.asarray(deleted))
    jl = jlti.LTIState(jg2, jnp.asarray(codes),
                       jpq.PQCodebook(jnp.asarray(cent)))
    return kind, pts, qs, jl, convert.lti_state(jg2, codes, cent, "cpu"), \
        np.nonzero(deleted)[0]


@pytest.mark.parametrize("W,L", [(1, 24), (4, 16)])
@pytest.mark.parametrize("rerank", [True, False])
def test_search_lti_matches_reference(carried_lti, W, L, rerank):
    """The LTI lane: PQ-ADC navigation + exact rerank; the DeleteList
    member is never returned."""
    kind, pts, qs, jl, tl, dead = carried_lti
    a = jlti.search_lti(jl, jnp.asarray(qs), JIndexConfig(**KW), k=5, L=L,
                        rerank=rerank, beam_width=W)
    b = tlti.search_lti(tl, torch.from_numpy(qs), IndexConfig(**KW), k=5,
                        L=L, rerank=rerank, beam_width=W)
    assert not np.isin(b[0].numpy(), dead).any()
    if kind == "integer":
        for x, y, name in zip(a, b, ["ids", "dists", "hops", "cmps"]):
            np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                          err_msg=name)
    else:
        assert abs(_recall(np.asarray(a[0]), pts, qs)
                   - _recall(b[0].numpy(), pts, qs)) <= 0.01
