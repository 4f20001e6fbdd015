"""GraphSAGE in the port against the reference, on the CPU at small sizes.

Reference parameters come from ``repro.models.gnn.init_sage_params`` and
cross to the port through ``convert.sage_params``; graphs from both
packages' ``synthetic_graph`` (byte-equal).  Tolerances:

* forwards and losses: rtol 1e-5, atol 1e-6 (the port's products are
  f64 rounded once, the reference's f32);
* gradients: rtol 1e-4, atol 1e-6 x the leaf's largest |g|;
* the chunked segment mean against its unchunked form: equal bits,
  forward and backward (each segment summed in edge order by both).

The sampled forward is fed the reference's frontiers (its sampler draws
from ``jax.random``); the port's own sampler is held to the adjacency
contract.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.data import pipelines as jpipe  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.common import gnn_cell_config  # noqa: E402
from repro_torch.data import pipelines as tpipe  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-6)


def _cfgs(**kw):
    j = dataclasses.replace(jconfigs.get_arch("graphsage-reddit")
                            .smoke_config, **kw)
    t = dataclasses.replace(tconfigs.get_arch("graphsage-reddit")
                            .smoke_config, **kw)
    return j, t


def _params(jcfg, tcfg, seed=0):
    jp = jgnn.init_sage_params(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.sage_params(jax.tree.map(np.asarray, jp), tcfg,
                                   "cpu")


def _grads_close(jgrads, tgrads):
    for path, a, b in zip(tree_paths(tgrads), jax.tree.leaves(jgrads),
                          tree_leaves(tgrads)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4,
                                   atol=1e-6 * np.abs(a).max(),
                                   err_msg=path)


def _port_grads(loss, params):
    live = tree_map(lambda t: t.clone().requires_grad_(), params)
    value = loss(live)
    value.backward()
    return value.detach(), tree_map(lambda t: t.grad, live)


@pytest.mark.parametrize("n,deg,seed", [(400, 8, 0), (401, 3, 9), (7, 1, 2)])
def test_synthetic_graph_byte_equal(n, deg, seed):
    a = jpipe.synthetic_graph(n, deg, 16, 7, seed=seed)
    b = tpipe.synthetic_graph(n, deg, 16, 7, seed=seed)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def _graph(n=300, e=2400, seed=1, isolated=True):
    g = np.random.default_rng(seed)
    src = g.integers(0, n, e)
    dst = (src + g.zipf(1.5, e)) % n
    if isolated:                          # no edge into or out of n - 1
        dst[dst == n - 1] = 0
        src[src == n - 1] = 1
    return src, dst, tgnn.SageGraph(torch.from_numpy(src),
                                    torch.from_numpy(dst), n)


@pytest.mark.parametrize("max_edges", [1, 13, None])
@pytest.mark.parametrize("mean", [True, False])
def test_segment_mean_chunked_equals_plain(max_edges, mean):
    """Chunks of one edge (one node a chunk wherever a node has edges),
    13 edges, and all nodes at once: the same bits as one gather and one
    ``segment_reduce``, forward and backward; and the segment sums of the
    reference's ``segment_sum``."""
    src, dst, graph = _graph()
    g = np.random.default_rng(2)
    h = torch.from_numpy(g.standard_normal((300, 9)).astype(np.float32))
    gy = torch.from_numpy(g.standard_normal((300, 9)).astype(np.float32))
    h1, h2 = h.clone().requires_grad_(), h.clone().requires_grad_()
    out1 = tgnn.segment_mean(h1, graph, mean, max_edges)
    out2 = tgnn.segment_mean_plain(h2, graph, mean)
    out1.backward(gy)
    out2.backward(gy)
    assert torch.equal(out1, out2)
    assert torch.equal(h1.grad, h2.grad)
    if max_edges is None:
        assert len(graph.plan("in", tgnn._max_edges(h, None))) == 1
    want = jax.ops.segment_sum(jnp.asarray(h.numpy())[src], dst,
                               num_segments=300)
    if mean:
        deg = jax.ops.segment_sum(jnp.ones(len(dst)), dst, num_segments=300)
        want = want / jnp.maximum(deg, 1.0)[:, None]
    np.testing.assert_allclose(out1.detach().numpy(), np.asarray(want),
                               **FWD)


def test_segment_mean_gradcheck_f64():
    src, dst, graph = _graph(n=30, e=80, seed=3)
    h = torch.randn(30, 4, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    for max_edges in (1, 7, None):
        assert torch.autograd.gradcheck(
            lambda x: tgnn.segment_mean(x, graph, True, max_edges), (h,))


def test_full_forward_loss_grads_vs_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    g = jpipe.synthetic_graph(400, 8, jcfg.d_feat, jcfg.n_classes, seed=4)
    mask = np.random.default_rng(5).random(400) < 0.3
    graph = tgnn.SageGraph(torch.from_numpy(g["src"]),
                           torch.from_numpy(g["dst"]), 400)
    feats = torch.from_numpy(g["feats"])
    want = jgnn.sage_forward_full(jp, g["feats"], g["src"], g["dst"], jcfg)
    got = tgnn.sage_forward_full(tp, feats, graph, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    jl, jg = jax.value_and_grad(jgnn.sage_loss_full)(
        jp, g["feats"], g["src"], g["dst"], g["labels"], mask, jcfg)
    tl, tg = _port_grads(lambda p: tgnn.sage_loss_full(
        p, feats, graph, torch.from_numpy(g["labels"]),
        torch.from_numpy(mask), tcfg), tp)
    np.testing.assert_allclose(float(tl), float(jl), **FWD)
    _grads_close(jg, tg)


def _ref_frontiers(key, g, seeds, cfg):
    keys = jax.random.split(key, cfg.n_layers)
    fr = [jnp.asarray(seeds)]
    for l in range(cfg.n_layers):
        fr.append(jgnn.sample_neighbors(keys[l], jnp.asarray(g["offsets"]),
                                        jnp.asarray(g["nbrs"]), fr[-1],
                                        cfg.fanout[l]))
    return [torch.from_numpy(np.array(f)) for f in fr]


@pytest.mark.parametrize("fanout", [(5, 3), (4, 2, 3)])
def test_sampled_forward_loss_grads_vs_reference(fanout):
    jcfg, tcfg = _cfgs(fanout=fanout, n_layers=len(fanout))
    jp, tp = _params(jcfg, tcfg, seed=1)
    g = jpipe.synthetic_graph(512, 8, jcfg.d_feat, jcfg.n_classes, seed=6)
    seeds = np.random.default_rng(7).integers(0, 512, 24).astype(np.int32)
    labels = g["labels"][seeds]
    key = jax.random.PRNGKey(3)
    fr = _ref_frontiers(key, g, seeds, jcfg)
    feats = torch.from_numpy(g["feats"])
    want = jgnn.sage_forward_sampled(jp, key, g["feats"], g["offsets"],
                                     g["nbrs"], seeds, jcfg)
    got = tgnn.sage_forward_sampled(tp, None, feats, None, None, None, tcfg,
                                    frontiers=fr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    jl, jg = jax.value_and_grad(jgnn.sage_loss_sampled)(
        jp, key, g["feats"], g["offsets"], g["nbrs"], seeds, labels, jcfg)
    tl, tg = _port_grads(lambda p: tgnn.sage_loss_sampled(
        p, None, feats, None, None, None, torch.from_numpy(labels), tcfg,
        frontiers=fr), tp)
    np.testing.assert_allclose(float(tl), float(jl), **FWD)
    _grads_close(jg, tg)


def _molecules(G=6, n=10, e=16, F=8, seed=8):
    g = np.random.default_rng(seed)
    mask = g.random((G, e)) < 0.7
    mask[0] = False                       # a graph with no edge
    return (g.standard_normal((G, n, F)).astype(np.float32),
            g.integers(0, n, (G, e)).astype(np.int32),
            g.integers(0, n, (G, e)).astype(np.int32), mask,
            g.integers(0, 2, G).astype(np.int32))


def _ref_batched_loss(p, feats, src, dst, mask, labels, cfg):
    logits = jgnn.sage_forward_batched(p, feats, src, dst, mask, cfg)
    lse = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)[:, 0]
    return (lse - gold).mean()


def test_batched_forward_loss_grads_vs_reference():
    jcfg, tcfg = _cfgs(d_feat=8, n_classes=2)
    jp, tp = _params(jcfg, tcfg, seed=2)
    feats, src, dst, mask, labels = _molecules()
    t = [torch.from_numpy(x) for x in (feats, src, dst, mask, labels)]
    want = jgnn.sage_forward_batched(jp, feats, src, dst, mask, jcfg)
    got = tgnn.sage_forward_batched(tp, *t[:4], tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    jl, jg = jax.value_and_grad(_ref_batched_loss)(
        jp, feats, src, dst, mask, labels, jcfg)
    graph = tgnn.batched_graph(t[1], t[2], t[3], feats.shape[1])
    assert graph.n_edges == int(mask.sum())
    tl, tg = _port_grads(lambda p: tgnn.sage_loss_batched(
        p, *t, tcfg, graph=graph), tp)
    np.testing.assert_allclose(float(tl), float(jl), **FWD)
    _grads_close(jg, tg)


def test_sampler_adjacency_contract():
    """Every draw is an in-neighbour of its node (``nbrs`` between its
    offsets), an isolated node samples itself, one seed gives one draw,
    and the draw is ``nbrs[offsets[v] + r % deg(v)]`` for the generator's
    r in [0, 2**30)."""
    g = tpipe.synthetic_graph(300, 4, 4, 3, seed=1)
    dst = g["dst"].copy()
    n = 300
    keep = dst != n - 1                   # node n - 1 left isolated
    src, dst = g["src"][keep], dst[keep]
    order = np.argsort(dst, kind="stable")
    nbrs = torch.from_numpy(src[order])
    offsets = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(dst, minlength=n))]).astype(np.int32))
    nodes = torch.from_numpy(np.array([[0, 5, n - 1], [17, n - 1, 3]]))
    gen = torch.Generator().manual_seed(4)
    got = tgnn.sample_neighbors(gen, offsets, nbrs, nodes, 6)
    assert got.shape == (2, 3, 6) and got.dtype == torch.int64
    r = torch.randint(0, 1 << 30, (2, 3, 6),
                      generator=torch.Generator().manual_seed(4))
    off = offsets.numpy().astype(np.int64)
    for idx in np.ndindex(2, 3):
        v = int(nodes[idx])
        lo, hi = off[v], off[v + 1]
        if hi == lo:
            assert (got[idx] == v).all()
        else:
            assert set(got[idx].tolist()) <= set(nbrs[lo:hi].tolist())
            want = nbrs[lo + r[idx] % (hi - lo)]
            assert torch.equal(got[idx], want.long())
    again = tgnn.sample_neighbors(torch.Generator().manual_seed(4), offsets,
                                  nbrs, nodes, 6)
    assert torch.equal(got, again)
    jcfg, tcfg = _cfgs()
    fr = tgnn.sample_frontiers(9, offsets, nbrs, nodes[0], tcfg)
    assert [tuple(f.shape) for f in fr] == [(3,), (3, 5), (3, 5, 3)]


def _spec_eq(a, b):
    return (tuple(a.shape) == tuple(b.shape)
            and np.dtype(a.dtype).name == str(b.dtype).split(".")[-1])


def test_gnn_cells_and_cell_config_match_reference():
    """The four cells' kinds, meta and input shapes; the sampled cell's
    ``jax.random`` key (uint32 [2]) is the port's per-step ``seed``
    (int64 []).  The per-cell config is the reference launch layer's."""
    ja = jconfigs.get_arch("graphsage-reddit")
    ta = tconfigs.get_arch("graphsage-reddit")
    assert ta.family == ja.family == "gnn"
    for which in ("full_config", "smoke_config"):
        assert (dataclasses.asdict(getattr(ja, which))
                == dataclasses.asdict(getattr(ta, which)))
    for jc, tc in zip(ja.cells, ta.cells, strict=True):
        assert (jc.shape, jc.kind, jc.meta, jc.skip) == (
            tc.shape, tc.kind, tc.meta, tc.skip)
        js, ts = jc.specs(), tc.specs()
        if "key" in js:
            assert tuple(js.pop("key").shape) == (2,)
            seed = ts.pop("seed")
            assert seed.shape == () and seed.dtype == torch.int64
        assert js.keys() == ts.keys()
        assert all(_spec_eq(js[k], ts[k]) for k in js)
        want = dataclasses.replace(
            ja.full_config, d_feat=jc.meta["d_feat"],
            n_classes=jc.meta["n_classes"],
            fanout=tuple(jc.meta.get("fanout", ja.full_config.fanout)))
        assert (dataclasses.asdict(gnn_cell_config(ta.full_config, tc))
                == dataclasses.asdict(want))
    assert gnn_cell_config(ta.full_config,
                           ta.cell("minibatch_lg")).fanout == (15, 10)


def test_init_and_convert_round_trip():
    jcfg, tcfg = _cfgs()
    a = tgnn.init_sage_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    b = tgnn.init_sage_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    jp = jgnn.init_sage_params(jax.random.PRNGKey(0), jcfg)
    assert tree_paths(a) == tree_paths(jax.tree.map(np.asarray, jp))
    assert [tuple(x.shape) for x in tree_leaves(a)] == [
        x.shape for x in jax.tree.leaves(jp)]
    back = convert.sage_to_numpy(convert.sage_params(
        jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, np.asarray(y))
    with pytest.raises(ValueError):
        convert.sage_params(jax.tree.map(np.asarray, jp),
                            dataclasses.replace(tcfg, d_hidden=8), "cpu")
