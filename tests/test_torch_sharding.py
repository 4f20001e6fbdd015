"""The model-sharding half of ``distributed/`` in the port against the
reference, on the CPU: the mesh and the sharding rules, ``Sharded``
leaves, the activation-sharding context's specs, the data-parallel train
step over a ``[cpu] * 4`` 2 x 2 mesh, the resharding restore and the
loop resumed over the mesh.

Tolerances:

* rule parity and ``shard_act``'s spec sequences: equal (a spec padded
  with None to the leaf's rank);
* round trips (shard -> full, the restore both ways, the resumed run):
  bit for bit;
* the sharded step against the reference's ``make_train_step``: each
  step's loss and metrics within 1e-4 relative, as
  ``tests/test_torch_training.py`` holds the unsharded step; against the
  port's unsharded step, bit for bit where the shards' sums are the
  unsharded microbatch sums (equal microbatches).
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.data import pipelines as jpipe  # noqa: E402
from repro.distributed import ctx as jctx  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.distributed import ctx as tctx  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402
from repro_torch.tree import (module_tree, tree_leaves,  # noqa: E402
                              tree_map, tree_paths)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ARCHS = [a for a in tconfigs.list_archs() if a != "freshdiskann-1b"]
TABLES = ("V'", "w_lin", "item_emb")        # launch/build.py's names


def _meshes(key):
    shape, names = MESHES[key]
    return (AbstractMesh(shape, names),
            tsh.Mesh(np.array([torch.device("cpu")] * int(np.prod(shape)),
                              dtype=object).reshape(shape), names))


def _cpu_mesh(shape=(2, 2), names=("data", "model")):
    return tsh.Mesh(np.array([torch.device("cpu")] * int(np.prod(shape)),
                             dtype=object).reshape(shape), names)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _dotted(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _ref_specs(shardings) -> list:
    """(dotted path, spec padded to the rank) of a tree of the reference's
    NamedShardings over an abstract tree."""
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return [(_dotted(p), tuple(s.spec)) for p, s in flat]


def _pad(spec, rank):
    return tuple(spec) + (None,) * (rank - len(tuple(spec)))


def _compare(ref_shardings, ref_abstract, port_shardings, port_tree):
    ref = _ref_specs(ref_shardings)
    shapes = [x.shape for x in jax.tree.leaves(ref_abstract)]
    port = list(zip(tree_paths(port_tree),
                    [s.spec for s in tree_leaves(port_shardings)],
                    [tuple(x.shape) for x in tree_leaves(port_tree)]))
    assert [p for p, _ in ref] == [p for p, _, _ in port]
    for (path, rspec), shape, (_, pspec, pshape) in zip(ref, shapes, port):
        assert tuple(shape) == pshape, path
        assert _pad(rspec, len(shape)) == pspec, (path, rspec, pspec)


def _port_lm_tree(cfg):
    tree: dict = {}
    for name, (shape, dtype, _) in ttf.param_layout(cfg).items():
        ttf.set_param(tree, name, torch.empty(shape, dtype=dtype,
                                              device="meta"))
    return tree


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rule_parity_full_config(arch, mesh_key):
    """Every leaf of every arch's FULL config gets the reference's spec:
    ``lm_param_shardings`` (``fsdp_rule``) and ``cache_shardings`` for the
    LMs, ``generic_param_shardings`` with the tables
    (``table_sharding``) for recsys and without for GraphSAGE."""
    jmesh, tmesh = _meshes(mesh_key)
    spec = tconfigs.get_arch(arch)
    jcfg = jconfigs.get_arch(arch).full_config
    cfg = spec.full_config
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    if spec.family == "lm":
        ja = jtf.abstract_params(jcfg)
        tree = _port_lm_tree(cfg)
        _compare(jsh.lm_param_shardings(jmesh, ja), ja,
                 tsh.lm_param_shardings(tmesh, tree), tree)
        for batch, max_len in ((8, 4096), (3, 32_768)):
            jc = jtf.abstract_cache(jcfg, batch, max_len)
            tc = ttf.init_cache(cfg, batch, max_len, device="meta")
            _compare(jsh.cache_shardings(jmesh, jc, batch), jc,
                     tsh.cache_shardings(tmesh, tc, batch), tc)
        return
    if spec.family == "recsys":
        ja = jax.eval_shape(lambda k: jrec.init_recsys_params(k, jcfg), key)
        with torch.device("meta"):
            tree = module_tree(trec.make_model(cfg))
        _compare(jsh.generic_param_shardings(jmesh, ja, table_names=TABLES),
                 ja, tsh.generic_param_shardings(
                     tmesh, tree, table_names=ttrain.RECSYS_TABLES), tree)
        return
    ja = jax.eval_shape(lambda k: jgnn.init_sage_params(k, jcfg), key)
    tree = tgnn.init_sage_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    _compare(jsh.generic_param_shardings(jmesh, ja), ja,
             tsh.generic_param_shardings(tmesh, tree), tree)


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_fsdp_rule_and_spec_for_by_hand(mesh_key):
    """``fsdp_rule``, ``table_sharding``, ``spec_for`` and
    ``_generic_spec`` on hand-made shapes (tiny and indivisible dims,
    names the LMs do not use) give the reference's specs."""
    jmesh, tmesh = _meshes(mesh_key)
    cases = [("embed", (6, 8)), ("lm_head", (8, 6)), ("blocks.0.ln1", (8,)),
             ("blocks.0.mlp.b", (3, 8)), ("blocks.0.wq", (2, 8, 3, 4)),
             ("blocks.0.xwk", (2, 8, 3, 4)), ("blocks.0.wo", (2, 3, 4, 8)),
             ("blocks.0.w_gate", (2, 8, 12)), ("blocks.0.w_up", (2, 3, 8, 12)),
             ("blocks.0.w_down", (2, 12, 8)), ("blocks.0.moe.w_down",
                                               (2, 3, 12, 8)),
             ("blocks.0.moe.router", (2, 8, 3)), ("x", (5, 7, 9)),
             ("y", (8, 8, 2)), ("z", (7,))]

    def keystr(path):
        return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                       for p in path.split("."))
    for path, shape in cases:
        want = _pad(jsh.fsdp_rule(jmesh, keystr(path), shape), len(shape))
        assert tsh.fsdp_rule(tmesh, path, shape) == want, path
        assert tsh.table_sharding(tmesh, shape) == _pad(
            jsh.table_sharding(jmesh, shape), len(shape))
        assert tsh._generic_spec(tmesh, shape) == _pad(
            jsh._generic_spec(jmesh, shape), len(shape))
    for wants in (["data", "data"], [("data", "model"), "model"],
                  [None, "model"]):
        assert tsh.spec_for(tmesh, (8, 8), wants) == _pad(
            jsh.spec_for(jmesh, (8, 8), wants), 2)
    assert tsh.batch_axes(tmesh) == jsh.batch_axes(jmesh)


# ---------------------------------------------------------------------------
# shard_act / gathered: the same specs in the same order
# ---------------------------------------------------------------------------

def _record(monkeypatch):
    """Patch both packages' constraint points; return the two lists of
    specs (padded to the rank) in call order."""
    ref, port = [], []

    def jrec_(x, sharding):
        ref.append(_pad(sharding, x.ndim))
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", jrec_)
    monkeypatch.setattr(jctx, "NamedSharding", lambda mesh, spec: spec)

    def trec_(x, spec):
        port.append(tuple(spec))
        return x
    monkeypatch.setattr(tctx, "_constrain", trec_)
    return ref, port


@pytest.mark.parametrize("mesh_key", ["2x2", "2x2x2"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_shard_act_specs_lm_forward(monkeypatch, arch, mesh_key):
    """One smoke-size forward (one layer a pattern position, as the
    reference's scan traces its body once) emits the reference's sequence
    of ``shard_act`` / ``gathered`` specs, in order: the embedding, each
    layer's weights, attention blocks, residual stream and (for the MoE)
    dispatch buffers, the head."""
    shape, names = (((2, 2), ("data", "model")) if mesh_key == "2x2"
                    else MESHES["2x2x2"])
    jcfg = jconfigs.get_arch(arch).smoke_config
    cfg = tconfigs.get_arch(arch).smoke_config
    n = len(cfg.pattern)
    jcfg = dataclasses.replace(jcfg, n_layers=n)
    cfg = dataclasses.replace(cfg, n_layers=n)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params(_np_tree(jp), cfg, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16)).astype(
        np.int32)
    ref, port = _record(monkeypatch)
    with jctx.activation_sharding(AbstractMesh(shape, names)):
        jtf.forward(jp, jnp.asarray(toks), jcfg)
    with tctx.activation_sharding(_cpu_mesh(shape, names)):
        ttf.forward(tp, torch.from_numpy(toks), cfg)
    assert len(ref) > 10 and port == ref
    assert any(s[0] is not None for s in port)


def test_shard_act_specs_moe_and_retrieval(monkeypatch):
    """``moe_ffn`` alone (two dispatch groups, drops at cf 1.0) and the
    recsys retrieval scores (both of the reference's branches) emit the
    reference's specs; outside a context nothing is emitted."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    mesh_shape, names = (2, 2), ("data", "model")
    D, E, K, Fd = 8, 4, 2, 12
    jcfg = jmoe.MoEConfig(n_experts=E, top_k=K, d_model=D, d_ff=Fd,
                          n_groups=2, capacity_factor=1.0)
    tcfg = tmoe.MoEConfig(n_experts=E, top_k=K, d_model=D, d_ff=Fd,
                          n_groups=2, capacity_factor=1.0)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(1).standard_normal((4, 16, D)).astype(
        np.float32)
    g = np.random.default_rng(2)
    q = g.standard_normal((8, 4)).astype(np.float32)
    ref, port = _record(monkeypatch)
    with jctx.activation_sharding(AbstractMesh(mesh_shape, names)):
        jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
        for C, k in ((64, 3), (60, 3), (64, 5)):
            table = g.standard_normal((C, 4)).astype(np.float32)
            jrec.retrieval_topk(jnp.asarray(q), jnp.asarray(table), k)
    g = np.random.default_rng(2)
    q = g.standard_normal((8, 4)).astype(np.float32)
    with tctx.activation_sharding(_cpu_mesh(mesh_shape, names)):
        tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
        for C, k in ((64, 3), (60, 3), (64, 5)):
            table = g.standard_normal((C, 4)).astype(np.float32)
            trec.retrieval_topk(torch.from_numpy(q), torch.from_numpy(table),
                                k)
    assert len(ref) == 9 + 4 and port == ref
    port.clear()
    tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    assert port == []


@pytest.mark.parametrize("window", [0, 8])
def test_shard_act_specs_flash_backward(monkeypatch, window):
    """The flash attention's gradient emits the reference's specs, forward
    then backward, in order, also when the backward runs outside the
    context (as in autograd's device thread on the card): the backward
    keeps the forward's mesh."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    B, S, H, KV, dh = 4, 32, 4, 2, 8
    g = np.random.default_rng(3)
    q, k, v = (g.standard_normal((B, S, h, dh)).astype(np.float32)
               for h in (H, KV, KV))
    kw = dict(window=window, q_chunk=8, kv_chunk=8)
    ref, port = _record(monkeypatch)
    with jctx.activation_sharding(AbstractMesh((2, 2), ("data", "model"))):
        jax.grad(lambda *a: jlayers.chunked_attention(*a, **kw).sum(),
                 argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with tctx.activation_sharding(_cpu_mesh((2, 2), ("data", "model"))):
        out = tlayers.chunked_attention(tq, tk, tv, **kw).sum()
    n_fwd = len(port)
    out.backward()
    assert n_fwd == 3 and len(ref) == 3 + 10 and port == ref


def test_shard_act_rules():
    """The tag rules: 'batch' is the (pod, data) super-axis, a tag is
    dropped on an indivisible dim or an axis already used, tuples mix
    tags."""
    specs = []

    def rec(x, spec):
        specs.append(spec)
        return x
    orig = tctx._constrain
    tctx._constrain = rec
    try:
        x = torch.zeros(8, 6, 4, 3)
        with tctx.activation_sharding(_cpu_mesh((2, 2, 2),
                                                ("pod", "data", "model"))):
            tctx.shard_act(x, "batch", "model", "model", None)
            tctx.shard_act(x, ("batch", "model"), None, "data")
            tctx.shard_act(x, None, "model", None, "model")
            tctx.shard_act(x, "model")
        tctx.shard_act(x, "batch")
    finally:
        tctx._constrain = orig
    assert specs == [(("pod", "data"), "model", None, None),
                     (("pod", "data", "model"), None, None, None),
                     (None, "model", None, None),
                     ("model", None, None, None)]


# ---------------------------------------------------------------------------
# Sharded leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [(), ("data",), (None, "model"),
                                  ("model", "data"), (("data", "model"),),
                                  (None, ("model", "data"), None)])
def test_shard_round_trip_and_blocks(spec):
    """``shard`` -> ``to_full`` is the identity; each block is its grid
    position's slice; replicas over unnamed axes are equal copies; the
    tree walks see the blocks as leaves and rebuild the leaf."""
    mesh = _cpu_mesh()
    x = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    s = tsh.shard(mesh, x, spec)
    assert torch.equal(tsh.to_full(s), x)
    assert len(s.blocks) == 4 and s.spec == _pad(spec, 3)
    for pos in mesh.positions():
        assert torch.equal(s.block(pos), x[tsh._slices(mesh, s.spec,
                                                       x.shape, pos)])
        assert torch.equal(s.gather(pos), x)
    leaves = tree_leaves({"w": s})
    assert len(leaves) == 4 and all(b is c for b, c in zip(leaves, s.blocks))
    back = tree_map(lambda b: b * 2, {"w": s})["w"]
    assert isinstance(back, tsh.Sharded) and torch.equal(tsh.to_full(back),
                                                          2 * x)
    assert tree_paths({"w": s}) == ["w.0", "w.1", "w.2", "w.3"]
    assert tree_paths({"w": s}, is_leaf=tsh.is_sharded) == ["w"]


def test_stacked_leaf_indexing_and_unbind():
    """``[gi]`` and ``unbind`` on the leading axis, sharded or not, give
    the layer's whole value and send its gradient to the owning block."""
    mesh = _cpu_mesh()
    x = torch.randn(4, 6, 2, generator=torch.Generator().manual_seed(0))
    for spec in ((None, "model"), ("data", "model"), (("data", "model"),)):
        s = tsh.shard(mesh, x, spec)
        for gi, part in enumerate(s.unbind(0)):
            assert torch.equal(part.gather(), x[gi])
            assert torch.equal(s[gi].gather((1, 1)), x[gi])
        live = s.with_blocks([b.clone().requires_grad_() for b in s.blocks])
        w = torch.randn(4, 6, 2)
        loss = sum((p.gather() * w[i]).sum()
                   for i, p in enumerate(live.unbind(0)))
        grads = torch.autograd.grad(loss, live.blocks, allow_unused=True)
        total = torch.zeros_like(x)
        for pos, g in zip(mesh.positions(), grads):
            if g is not None:
                total[tsh._slices(mesh, live.spec, x.shape, pos)] += g
        assert torch.equal(total, w)


def test_gathered_gradient_reaches_every_block():
    """Under the context ``gathered`` at grid position (1, 0) reads row
    1's replicas: the blocks it reads get their slices of the gradient,
    the rest none; the replicated spec is emitted; outside a context a
    plain tensor passes through as it is."""
    mesh = _cpu_mesh()
    x = torch.randn(8, 6)
    c = torch.randn(8, 6)
    for spec in (("model", None), (("data", "model"), None),
                 (None, "data")):
        s = tsh.shard(mesh, x, spec)
        live = s.with_blocks([b.clone().requires_grad_() for b in s.blocks]
                             ).at((1, 0))
        with tctx.activation_sharding(mesh):
            full = tctx.gathered(live)
        assert torch.equal(full, x)
        grads = torch.autograd.grad((full * c).sum(), live.blocks,
                                    allow_unused=True)
        for pos, g in zip(mesh.positions(), grads):
            named = {a for e in live.spec if e
                     for a in ((e,) if isinstance(e, str) else e)}
            reads = all(i == (1, 0)[k] for k, (a, i) in enumerate(
                zip(mesh.axis_names, pos)) if a not in named)
            if reads:
                assert torch.equal(g, c[tsh._slices(mesh, live.spec, x.shape,
                                                    pos)])
            else:
                assert g is None
    t = torch.randn(3)
    assert tctx.gathered(t) is t and tctx.shard_act(t, "batch") is t


def test_place_batch_and_data_positions():
    """The batch's rows split over the batch axes (pod, data), replicated
    over model; the data shards' grid positions row-major, model 0."""
    mesh = _cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    assert tsh.data_positions(mesh) == [(0, 0, 0), (0, 1, 0), (1, 0, 0),
                                        (1, 1, 0)]
    b = tsh.place_batch(mesh, {"x": np.arange(16).reshape(8, 2),
                               "seed": 3})
    assert b["seed"] == 3 and b["x"].spec == (("pod", "data"), None)
    for s, pos in enumerate(tsh.data_positions(mesh)):
        part = tsteps.shard_part(b, s, 4, pos, "cpu")["x"]
        assert part.tolist() == np.arange(16).reshape(8, 2)[
            2 * s:2 * s + 2].tolist()
    host = tsh.host_mesh(model=2, devices=["cpu"] * 4)
    assert dict(host.shape) == {"data": 2, "model": 2}
    assert dict(tsh.host_mesh(device="cpu").shape) == {"data": 1,
                                                        "model": 1}


# ---------------------------------------------------------------------------
# The data-parallel step against the reference
# ---------------------------------------------------------------------------

def _step_case(form):
    """(reference loss, port loss, batches i -> (ref, port), reference
    params, port params, family) at smoke size."""
    if form in ("lm", "moe"):
        arch = "qwen2-1.5b" if form == "lm" else "qwen3-moe-30b-a3b"
        jcfg = jconfigs.get_arch(arch).smoke_config
        cfg = tconfigs.get_arch(arch).smoke_config
        jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        tp = convert.lm_params(_np_tree(jp), cfg, "cpu")
        stream = jpipe.lm_token_stream(8, 16, jcfg.vocab, seed=2)
        data = [next(stream) for _ in range(3)]

        def jl(p, b):
            return jtf.lm_loss(p, b["tokens"], b["targets"], jcfg)
        return (jl, ttrain.train_loss("lm", cfg),
                lambda i: (data[i], data[i]), jp, tp, "lm")
    if form == "fm":
        jcfg = jconfigs.get_arch("fm").smoke_config
        cfg = tconfigs.get_arch("fm").smoke_config
        jp = jrec.init_recsys_params(jax.random.PRNGKey(0), jcfg)
        tp = module_tree(convert.recsys_model(_np_tree(jp), cfg, "cpu"))
        stream = jpipe.click_stream(32, jcfg.n_sparse, jcfg.rows_per_field,
                                    seed=4)
        data = [next(stream) for _ in range(3)]

        def jl(p, b):
            loss = jrec.recsys_loss(p, b["ids"], b["labels"], jcfg)
            return loss, {"logloss": loss}
        return (jl, ttrain.train_loss("recsys", cfg),
                lambda i: (data[i], data[i]), jp, tp, "recsys")
    jcfg = dataclasses.replace(
        jconfigs.get_arch("graphsage-reddit").smoke_config, d_feat=8,
        n_classes=2)
    cfg = dataclasses.replace(
        tconfigs.get_arch("graphsage-reddit").smoke_config, d_feat=8,
        n_classes=2)
    jp = jgnn.init_sage_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.sage_params(_np_tree(jp), cfg, "cpu")
    g = np.random.default_rng(3)
    G, n, e = 8, 10, 16
    b0 = {"feats": g.standard_normal((G, n, 8)).astype(np.float32),
          "src": g.integers(0, n, (G, e)).astype(np.int32),
          "dst": g.integers(0, n, (G, e)).astype(np.int32),
          "edge_mask": g.random((G, e)) < 0.7,
          "labels": g.integers(0, 2, G).astype(np.int32)}
    b0["feats"][:, :, 0] += b0["labels"][:, None]

    def jl(p, b):
        logits = jgnn.sage_forward_batched(p, b["feats"], b["src"],
                                           b["dst"], b["edge_mask"], jcfg)
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, b["labels"][:, None],
                                   axis=-1)[:, 0]
        loss = (lse - gold).mean()
        return loss, {"ce": loss}

    def tl(p, b):
        p = tree_map(tctx.whole, p, is_leaf=tsh.is_sharded)
        loss = tgnn.sage_loss_batched(p, b["feats"], b["src"], b["dst"],
                                      b["edge_mask"], b["labels"], cfg)
        return loss, {"ce": loss}
    return jl, tl, lambda i: (b0, b0), jp, tp, "gnn"


@pytest.mark.parametrize("form", ["lm", "moe", "fm", "graphsage"])
def test_sharded_step_matches_reference(form):
    """The sharded train step over a ``[cpu] * 4`` 2 x 2 mesh (the
    family's rule; batches placed over the data axis; 4 microbatches,
    2 a data shard) against the reference's ``make_train_step``
    (``accum_steps`` 4) over 3 steps: losses and metrics within 1e-4
    relative, the first step's equal to the port's unsharded step's bit
    for bit (the same parameters, the same microbatches)."""
    jl, tl, batch, jp, tp, family = _step_case(form)
    mesh = _cpu_mesh()
    kw = dict(lr=1e-3, accum_steps=4)
    jstep = jax.jit(jsteps.make_train_step(jl, **kw))
    sstep = tsteps.make_train_step(tl, mesh=mesh, **kw)
    ustep = tsteps.make_train_step(tl, **kw)
    sp = tsh.place_tree(tp, ttrain.param_shardings(family, mesh, tp))
    assert all(isinstance(x, tsh.Sharded)
               for x in tree_leaves(sp, is_leaf=tsh.is_sharded))
    jo, so = jadamw.adamw_init(jp), tadamw.adamw_init(sp)
    _, _, um = ustep(tp, tadamw.adamw_init(tp),
                     tree_map(torch.from_numpy, batch(0)[1]))
    for i in range(3):
        jb, tb = batch(i)
        jp, jo, jm = jstep(jp, jo, jb)
        sp, so, sm = sstep(sp, so, tsh.place_batch(mesh, tb))
        assert sm.keys() == jm.keys()
        for k in sm:
            np.testing.assert_allclose(float(sm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
            assert i or float(sm[k]) == float(um[k]), k
    assert int(so.step) == 3


def test_sharded_step_replicas_agree_and_norm_counts_owners():
    """The mean gradient over the mesh (``train_grads``, 2 microbatches:
    one a data shard) equals the unsharded one bit for bit, and every
    replica of a block holds it; after a step clipped at a tiny norm (the
    clip scale is 1 / the norm, so a slice counted twice would show) the
    replicas agree, the moments are the unsharded step's within rtol
    1e-5 (the norm's sums of squares run block by block) and each
    parameter within 1e-4 x lr of it."""
    jl, tl, batch, jp, tp, family = _step_case("lm")
    mesh = _cpu_mesh()
    sp = tsh.place_tree(tp, ttrain.param_shardings(family, mesh, tp))
    b = batch(0)[1]
    ls, _, gs = tsteps.train_grads(tl, accum_steps=2, mesh=mesh)(sp, b)
    lu, _, gu = tsteps.train_grads(tl, accum_steps=2)(
        tp, tree_map(torch.from_numpy, b))
    assert float(ls) == float(lu)
    for a, g in zip(tree_leaves(gu),
                    tree_leaves(gs, is_leaf=tsh.is_sharded)):
        assert torch.equal(tsh.to_full(g), a)
        for pos, blk in zip(mesh.positions(), g.blocks):
            assert torch.equal(blk, a[tsh._slices(mesh, g.spec, a.shape,
                                                  pos)])
    lr = 1e-3
    kw = dict(lr=lr, grad_clip=1e-3, accum_steps=2)
    sp2, so2, _ = tsteps.make_train_step(tl, mesh=mesh, **kw)(
        sp, tadamw.adamw_init(sp), b)
    up2, uo2, _ = tsteps.make_train_step(tl, **kw)(
        tp, tadamw.adamw_init(tp), tree_map(torch.from_numpy, b))
    for s in tree_leaves((sp2, so2.m, so2.v), is_leaf=tsh.is_sharded):
        groups: dict = {}
        for pos, blk in zip(mesh.positions(), s.blocks):
            groups.setdefault(s.slice_key(pos), []).append(blk)
        for copies in groups.values():
            assert all(torch.equal(copies[0], c) for c in copies[1:])
    for a, s in zip(tree_leaves((uo2.m, uo2.v)),
                    tree_leaves((so2.m, so2.v), is_leaf=tsh.is_sharded)):
        torch.testing.assert_close(tsh.to_full(s), a, rtol=1e-5,
                                   atol=1e-6 * float(a.abs().max()))
    for a, s in zip(tree_leaves(up2),
                    tree_leaves(sp2, is_leaf=tsh.is_sharded)):
        ulp = torch.finfo(a.dtype).eps * a.abs()
        assert bool(((tsh.to_full(s) - a).abs() <= 1e-4 * lr + 2 * ulp).all())


# ---------------------------------------------------------------------------
# Checkpoints: resharding restore and the resumed loop
# ---------------------------------------------------------------------------

def _sharded_state(mesh):
    _, tl, batch, _, tp, family = _step_case("lm")
    sp = tsh.place_tree(tp, ttrain.param_shardings(family, mesh, tp))
    step = tsteps.make_train_step(tl, mesh=mesh, lr=1e-3, accum_steps=2)
    sp, so, _ = step(sp, tadamw.adamw_init(sp), batch(0)[1])
    return {"params": sp, "opt": so}, tp


@pytest.mark.parametrize("direction", ["2x2_to_1x1", "1x1_to_2x2"])
def test_resharding_restore(tmp_path, direction):
    """A state saved from one mesh restores onto the other (and onto a
    device, and onto its own mesh): every leaf bit-equal to the saved
    full value, placed by the new shardings; the leaf files equal those
    of the same state saved unsharded."""
    big, small = _cpu_mesh(), _cpu_mesh((1, 1))
    src, dst = (big, small) if direction == "2x2_to_1x1" else (small, big)
    state, tp = _sharded_state(src)
    full = tree_map(tsh.to_full, state, is_leaf=tsh.is_sharded)
    tstore.save_checkpoint(str(tmp_path / "a"), 1, state)
    tstore.save_checkpoint(str(tmp_path / "b"), 1, full)
    da, db = (str(tmp_path / x / "step_0000000001") for x in "ab")
    assert sorted(os.listdir(da)) == sorted(os.listdir(db))
    for f in os.listdir(da):
        with open(os.path.join(da, f), "rb") as fa, \
                open(os.path.join(db, f), "rb") as fb:
            assert fa.read() == fb.read(), f
    want = tree_leaves(full)
    for mesh in (dst, src):
        params = tsh.place_tree(tp, ttrain.param_shardings("lm", mesh, tp))
        shardings = {"params": tsh.shardings_of(params),
                     "opt": tsh.shardings_of(tadamw.adamw_init(params))}
        got, step = tstore.restore_checkpoint(str(tmp_path / "a"),
                                              shardings=shardings)
        assert step == 1
        leaves = tree_leaves(got, is_leaf=tsh.is_sharded)
        for a, b, s in zip(leaves, want, tree_leaves(
                shardings, is_leaf=lambda x: isinstance(
                    x, (tsh.NamedSharding, torch.device)))):
            if isinstance(s, tsh.NamedSharding):
                assert a.mesh is mesh and a.spec == s.spec
            assert a.dtype == b.dtype and torch.equal(tsh.to_full(a), b)
    plain, _ = tstore.restore_checkpoint(str(tmp_path / "a"), device="cpu")
    for a, b in zip(tree_leaves(plain), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "fm"])
def test_run_training_over_mesh_resumes_bit_equal(tmp_path, arch):
    """``launch.train.main`` over a ``[cpu] * 4`` 2 x 2 mesh, four steps
    with a checkpoint every two; the last checkpoint deleted, the run
    resumed from step 2 onto the mesh's shardings: the same bits as the
    uninterrupted run, whose losses equal the 1 x 1 mesh's."""
    ckpt = str(tmp_path / "ck")
    argv = ["--arch", arch, "--device", "cpu", "--steps", "4", "--batch",
            "4", "--seq", "16", "--log-every", "2", "--ckpt-dir", ckpt]
    mesh = tsh.host_mesh(model=2, devices=["cpu"] * 4)
    pa, oa, la = ttrain.main(argv + ["--ckpt-every", "2"], mesh=mesh)
    assert all(isinstance(x, tsh.Sharded)
               for x in tree_leaves(pa, is_leaf=tsh.is_sharded))
    shutil.rmtree(os.path.join(ckpt, "step_0000000004"))
    pb, ob, lb = ttrain.main(argv + ["--ckpt-every", "100"], mesh=mesh)
    assert lb[-1]["loss"] == la[-1]["loss"]
    for a, b in zip(tree_leaves((pa, oa)), tree_leaves((pb, ob))):
        assert torch.equal(a, b)
    _, _, l1 = ttrain.main(argv[:-2])
    np.testing.assert_allclose([r["loss"] for r in la],
                               [r["loss"] for r in l1], rtol=1e-5)
