"""The training stack in the port against the reference, on the CPU:
AdamW, the train step, the loop, the checkpointer and ``launch.train``.

Tolerances (AdamW's first step moves each parameter by about
``sign(g) * lr``, so a gradient element near zero whose sign differs by
one rounding moves it by 2 lr; parameters after many steps are not
compared element for element):

* AdamW on identical numpy gradients: rtol 1e-6 (atol 1e-9);
* ``make_train_step`` against the reference's over 5 steps (3 for the
  MoE LMs and the cell trainers, at the smoke configs): losses within
  1e-4 relative;
* ``accum_steps=2`` against 1: the reference test's rtol 5e-3, atol
  5e-5 on the parameters;
* resume after a crash: bit for bit;
* checkpoints of one state: each ``leaf_%05d.npy`` equal in dtype, shape
  and bytes to the reference's.
"""
import collections
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
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.data import pipelines as jpipe  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402
from repro_torch.tree import (module_tree, tree_flatten,  # noqa: E402
                              tree_leaves, tree_map, tree_paths,
                              tree_unflatten)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["fm", "qwen2-1.5b"])
def test_train_step_leaves_no_cycle_holding_tensors(arch):
    """A train step (and ``tree_paths``) leaves no reference cycle that
    holds a tensor: with the cyclic garbage collector off, what it would
    collect after the step holds none.  (The tree walks were closures
    that called themselves, each a cycle holding its leaves: a step's
    gradients and AdamW's old moments stayed allocated until the
    collector ran.)"""
    import gc
    params, step, stream = ttrain.build_smoke_trainer(arch, 4, 16, 1e-3,
                                                      accum=2, device="cpu")
    opt = tadamw.adamw_init(params)
    batch = tree_map(torch.from_numpy, next(stream(0)))
    step(params, opt, batch)      # first calls import lazily, once
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        step(params, opt, batch)
        tree_paths(params)
        gc.collect()
        held = [tuple(o.shape) for o in gc.garbage
                if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []


def test_tree_order_is_the_references():
    Pair = collections.namedtuple("Pair", ["b", "a"])
    tree = {"z": [1, {"y": 2, "x": (3, 4)}], "a": Pair(5, None),
            "m": {"k": 6}}
    leaves, st = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree) == [5, 6, 1, 3, 4, 2]
    assert tree_unflatten(st, leaves) == tree
    assert tree_paths(tree) == ["a.b", "m.k", "z.0", "z.1.x.0", "z.1.x.1",
                                "z.1.y"]
    with pytest.raises(ValueError):
        tree_unflatten(st, leaves + [7])


@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_adamw_matches_reference_on_identical_grads(clip):
    """Three updates on the same numpy gradients, clipped and not: the
    parameters, m, v and the step, rtol 1e-6."""
    g = np.random.default_rng(0)
    params = {"w": g.standard_normal((5, 3)).astype(np.float32),
              "layers": [{"b": g.standard_normal(3).astype(np.float32)}]}
    jp, tp = params, tree_map(torch.from_numpy, params)
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    for i in range(3):
        grads = tree_map(lambda x: (g.standard_normal(x.shape) * 0.3)
                         .astype(np.float32), params)
        jp, js = jadamw.adamw_update(jp, grads, js, **kw)
        tp, ts = tadamw.adamw_update(tp, tree_map(torch.from_numpy, grads),
                                     ts, **kw)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    for a, b in zip(jax.tree.leaves((jp, js.m, js.v)),
                    tree_leaves((tp, ts.m, ts.v))):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-9)


def _lm_setup():
    jcfg = jconfigs.get_arch("qwen2-1.5b").smoke_config
    tcfg = tconfigs.get_arch("qwen2-1.5b").smoke_config
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.lm_params(_np_tree(jp), tcfg, "cpu")


def _gnn_setup(form):
    jcfg = jconfigs.get_arch("graphsage-reddit").smoke_config
    tcfg = tconfigs.get_arch("graphsage-reddit").smoke_config
    if form == "batched":
        jcfg = dataclasses.replace(jcfg, d_feat=8, n_classes=2)
        tcfg = dataclasses.replace(tcfg, d_feat=8, n_classes=2)
    jp = jgnn.init_sage_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.sage_params(_np_tree(jp), tcfg, "cpu")


def _loss_fns(form):
    """(reference loss_fn, port loss_fn, batches(step) -> (ref batch, port
    batch), reference params, port params) of one form."""
    if form == "lm":
        jcfg, tcfg, jp, tp = _lm_setup()
        stream = jpipe.lm_token_stream(4, 16, jcfg.vocab)
        data = [next(stream) for _ in range(5)]

        def jl(p, b):
            return jtf.lm_loss(p, b["tokens"], b["targets"], jcfg)

        def tl(p, b):
            return ttf.lm_loss(p, b["tokens"], b["targets"], tcfg)

        def batch(i):
            return data[i], tree_map(torch.from_numpy, data[i])
        return jl, tl, batch, jp, tp
    jcfg, tcfg, jp, tp = _gnn_setup(form)
    if form == "batched":
        g = np.random.default_rng(3)
        G, n, e = 6, 10, 16
        b0 = {"feats": g.standard_normal((G, n, 8)).astype(np.float32),
              "src": g.integers(0, n, (G, e)).astype(np.int32),
              "dst": g.integers(0, n, (G, e)).astype(np.int32),
              "edge_mask": g.random((G, e)) < 0.7,
              "labels": g.integers(0, 2, G).astype(np.int32)}
        b0["feats"][:, :, 0] += b0["labels"][:, None]

        def jl(p, b):
            logits = jgnn.sage_forward_batched(p, b["feats"], b["src"],
                                               b["dst"], b["edge_mask"],
                                               jcfg)
            lse = jax.nn.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, b["labels"][:, None],
                                       axis=-1)[:, 0]
            loss = (lse - gold).mean()
            return loss, {"ce": loss}

        def tl(p, b):
            loss = tgnn.sage_loss_batched(p, b["feats"], b["src"], b["dst"],
                                          b["edge_mask"], b["labels"], tcfg)
            return loss, {"ce": loss}

        def batch(i):
            return b0, tree_map(torch.from_numpy, b0)
        return jl, tl, batch, jp, tp
    g = jpipe.synthetic_graph(400, 8, jcfg.d_feat, jcfg.n_classes, seed=1)
    if form == "full":
        mask = np.random.default_rng(2).random(400) < 0.3
        graph = tgnn.SageGraph(torch.from_numpy(g["src"]),
                               torch.from_numpy(g["dst"]), 400)

        def jl(p, b):
            loss = jgnn.sage_loss_full(p, g["feats"], g["src"], g["dst"],
                                       g["labels"], mask, jcfg)
            return loss, {"ce": loss}

        def tl(p, b):
            loss = tgnn.sage_loss_full(p, torch.from_numpy(g["feats"]),
                                       graph, torch.from_numpy(g["labels"]),
                                       torch.from_numpy(mask), tcfg)
            return loss, {"ce": loss}

        def batch(i):
            return {}, {}
        return jl, tl, batch, jp, tp

    def jl(p, b):                                     # sampled
        loss = jgnn.sage_loss_sampled(p, b["key"], g["feats"], g["offsets"],
                                      g["nbrs"], b["seeds"], b["labels"],
                                      jcfg)
        return loss, {"ce": loss}

    def tl(p, b):
        loss = tgnn.sage_loss_sampled(p, None, torch.from_numpy(g["feats"]),
                                      None, None, None, b["labels"], tcfg,
                                      frontiers=b["frontiers"])
        return loss, {"ce": loss}

    def batch(i):
        seeds = np.random.default_rng([7, i]).integers(0, 400, 16).astype(
            np.int32)
        key = jax.random.PRNGKey(i)
        keys = jax.random.split(key, jcfg.n_layers)
        fr = [jnp.asarray(seeds)]
        for l in range(jcfg.n_layers):
            fr.append(jgnn.sample_neighbors(keys[l], g["offsets"], g["nbrs"],
                                            fr[-1], jcfg.fanout[l]))
        jb = {"seeds": seeds, "labels": g["labels"][seeds], "key": key}
        tb = {"labels": torch.from_numpy(g["labels"][seeds]),
              "frontiers": [torch.from_numpy(np.array(f)) for f in fr]}
        return jb, tb
    return jl, tl, batch, jp, tp


@pytest.mark.parametrize("form", ["lm", "full", "sampled", "batched"])
def test_train_step_matches_reference_over_five_steps(form):
    """Five AdamW steps of the lm smoke config and the three GraphSAGE
    forms: each step's loss within 1e-4 relative of the reference's."""
    jl, tl, batch, jp, tp = _loss_fns(form)
    if form == "lm":
        jstep = jax.jit(jsteps.make_train_step(jl, lr=1e-3))
    else:
        jstep = jsteps.make_train_step(jl, lr=3e-3)
    tstep = tsteps.make_train_step(tl, lr=1e-3 if form == "lm" else 3e-3)
    jo, to = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for i in range(5):
        jb, tb = batch(i)
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        assert tm.keys() == jm.keys()
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    assert int(to.step) == 5


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_moe_train_step_matches_reference_over_three_steps(arch):
    """Three AdamW steps of a MoE smoke LM (the MoE dispatch's gradients,
    the aux loss at weight 0.01) against the reference's
    ``make_train_step``: each step's loss, ce and aux within 1e-4
    relative."""
    jcfg = jconfigs.get_arch(arch).smoke_config
    tcfg = tconfigs.get_arch(arch).smoke_config
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params(_np_tree(jp), tcfg, "cpu")
    jstep = jax.jit(jsteps.make_train_step(
        lambda p, b: jtf.lm_loss(p, b["tokens"], b["targets"], jcfg),
        lr=1e-3))
    tstep = tsteps.make_lm_train_step(tcfg, lr=1e-3)
    jo, to = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    stream = jpipe.lm_token_stream(4, 16, jcfg.vocab)
    for _ in range(3):
        b = next(stream)
        jp, jo, jm = jstep(jp, jo, b)
        tp, to, tm = tstep(tp, to, tree_map(torch.from_numpy, b))
        assert tm.keys() == jm.keys()
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    assert float(tm["aux"]) > 0


def _smoke_cells(monkeypatch, arch):
    """``launch.train.get_arch`` giving ``arch`` with its smoke config in
    place of the FULL one (the cells keep the published shapes)."""
    spec = tconfigs.get_arch(arch)
    monkeypatch.setattr(ttrain, "get_arch", lambda name: dataclasses.replace(
        spec, full_config=spec.smoke_config))
    return spec


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_cell_trainer_lm_matches_reference_accumulated(monkeypatch, arch):
    """``build_cell_trainer(arch, "train_4k", accum_steps=4)`` at the smoke
    config: its stream yields the cell's B 256 x S 4,096 batches, and its
    step, over 3 batches of 8 x 16 split into 4 microbatches, gives the
    losses and metrics of the reference's ``make_train_step`` at its
    defaults (lr 3e-4, weight decay 0.1, clip 1.0) with ``accum_steps``
    4, within 1e-4 relative; ``n_layers`` cuts the depth."""
    spec = _smoke_cells(monkeypatch, arch)
    jcfg = jconfigs.get_arch(arch).smoke_config
    params, tstep, stream = ttrain.build_cell_trainer(
        arch, "train_4k", accum_steps=4, device="cpu")
    b0 = next(stream(0))
    want = spec.cell("train_4k").specs()
    assert {k: v.shape for k, v in b0.items()} == {
        k: want[k].shape for k in want}
    assert tree_paths(params) == tree_paths(convert.lm_params(
        _np_tree(jtf.init_params(jax.random.PRNGKey(0), jcfg)),
        spec.smoke_config, "cpu"))
    cut, _, _ = ttrain.build_cell_trainer(arch, "train_4k", n_layers=1,
                                          device="cpu")
    assert cut["blocks"][0]["wq"].shape[0] == 1
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params(_np_tree(jp), spec.smoke_config, "cpu")
    jstep = jax.jit(jsteps.make_train_step(
        lambda p, b: jtf.lm_loss(p, b["tokens"], b["targets"], jcfg),
        accum_steps=4))
    jo, to = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    data = jpipe.lm_token_stream(8, 16, jcfg.vocab, seed=3)
    for _ in range(3):
        b = next(data)
        jp, jo, jm = jstep(jp, jo, b)
        tp, to, tm = tstep(tp, to, tree_map(torch.from_numpy, b))
        assert tm.keys() == jm.keys()
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("kind", ["fm", "deepfm", "xdeepfm", "sasrec"])
def test_cell_trainer_recsys_matches_reference(monkeypatch, kind):
    """``build_cell_trainer(kind, "train_batch")`` at the smoke config: its
    stream yields the cell's batches of 65,536 rows, and its step, over 3
    batches of 32 rows, gives the losses of the reference's
    ``make_train_step`` at its defaults, within 1e-4 relative."""
    from repro.models import recsys as jrec
    spec = _smoke_cells(monkeypatch, kind)
    jcfg = jconfigs.get_arch(kind).smoke_config
    params, tstep, stream = ttrain.build_cell_trainer(kind, "train_batch",
                                                      device="cpu")
    b0 = next(stream(0))
    want = spec.cell("train_batch").specs()       # the FULL config's widths
    assert b0.keys() == want.keys() and all(
        v.shape[0] == want[k].shape[0] == 65_536 for k, v in b0.items())
    jp = jrec.init_recsys_params(jax.random.PRNGKey(0), jcfg)
    tp = module_tree(convert.recsys_model(_np_tree(jp), spec.smoke_config,
                                          "cpu"))
    assert tree_paths(tp) == tree_paths(params)
    if kind == "sasrec":
        def jl(p, b):
            loss = jrec.sasrec_loss(p, b["seq"], b["pos"], b["neg"], jcfg)
            return loss, {"bpr": loss}
        data = jpipe.sasrec_stream(32, jcfg.seq_len, jcfg.n_items, seed=4)
    else:
        def jl(p, b):
            loss = jrec.recsys_loss(p, b["ids"], b["labels"], jcfg)
            return loss, {"logloss": loss}
        data = jpipe.click_stream(32, jcfg.n_sparse, jcfg.rows_per_field,
                                  seed=4)
    jstep = jax.jit(jsteps.make_train_step(jl))
    jo, to = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for _ in range(3):
        b = next(data)
        jp, jo, jm = jstep(jp, jo, b)
        tp, to, tm = tstep(tp, to, tree_map(torch.from_numpy, b))
        assert tm.keys() == jm.keys()
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)


def test_grad_accumulation_equivalence():
    """accum_steps=2 against 1 on the same global batch (the lm smoke
    config), and the reference's accumulated step."""
    jcfg, tcfg, jp, tp = _lm_setup()
    toks = np.random.default_rng(1).integers(1, tcfg.vocab, (4, 16)).astype(
        np.int32)
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(np.roll(toks, -1, 1))}

    def loss_fn(p, b):
        return ttf.lm_loss(p, b["tokens"], b["targets"], tcfg)
    s1 = tsteps.make_train_step(loss_fn, lr=1e-3)
    s2 = tsteps.make_train_step(loss_fn, lr=1e-3, accum_steps=2)
    p1, _, m1 = s1(tp, tadamw.adamw_init(tp), batch)
    p2, o2, m2 = s2(tp, tadamw.adamw_init(tp), batch)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-3,
                                   atol=5e-5)
    js = jsteps.make_train_step(
        lambda p, b: jtf.lm_loss(p, b["tokens"], b["targets"], jcfg),
        lr=1e-3, accum_steps=2)
    jp2, _, jm2 = js(jp, jadamw.adamw_init(jp),
                     {k: v.numpy() for k, v in batch.items()})
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m2["ce"]), float(jm2["ce"]), rtol=1e-4)


def test_run_training_resume_is_bit_equal(tmp_path):
    """Six steps with a checkpoint every three; the step-6 checkpoint
    deleted ("crash"), the run resumed from step 3: the same bits."""
    _, tcfg, _, tp = _lm_setup()
    step = tsteps.make_lm_train_step(tcfg, lr=1e-3)

    def stream(s):
        from repro_torch.data.pipelines import lm_token_stream
        return lm_token_stream(4, 16, tcfg.vocab, start_step=s)
    ckpt = str(tmp_path / "run")
    logs = []
    pa, oa, la = tloop.run_training("cpu", step, tp, tadamw.adamw_init(tp),
                                    stream, n_steps=6, ckpt_dir=ckpt,
                                    ckpt_every=3, log_every=2,
                                    log_fn=logs.append)
    assert [r["step"] for r in la] == [2, 4, 6]
    assert sorted(os.listdir(ckpt)) == ["step_0000000003",
                                        "step_0000000006"]
    shutil.rmtree(os.path.join(ckpt, "step_0000000006"))
    pb, ob, lb = tloop.run_training("cpu", step, tp, tadamw.adamw_init(tp),
                                    stream, n_steps=6, ckpt_dir=ckpt,
                                    ckpt_every=100, log_fn=logs.append)
    assert any("restored checkpoint at step 3" in m for m in logs)
    assert isinstance(ob, tadamw.AdamWState) and int(ob.step) == 6
    for a, b in zip(tree_leaves((pa, oa)), tree_leaves((pb, ob))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert lb[-1]["loss"] == la[-1]["loss"]


@pytest.mark.parametrize("family", ["gnn", "lm"])
def test_checkpoint_leaves_equal_references(tmp_path, family):
    """One state -- parameters and an AdamW state after a step -- saved by
    both packages: the same leaf files, one for one; restored by the port
    to the same tensors; ``AsyncCheckpointer`` keeps the newest three."""
    _, _, jp, tp = _lm_setup() if family == "lm" else _gnn_setup("full")
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.01), jp)
    jp, jo = jadamw.adamw_update(jp, grads, jadamw.adamw_init(jp))
    tree_j = {"params": jp, "opt": jo}
    tp = (convert.lm_params(_np_tree(jp), tconfigs.get_arch(
        "qwen2-1.5b").smoke_config, "cpu") if family == "lm"
        else tree_map(lambda a: torch.from_numpy(np.array(a)), _np_tree(jp)))
    tree_t = {"params": tp, "opt": convert.adamw_state(_np_tree(jo), "cpu")}
    jdir = jstore.save_checkpoint(str(tmp_path / "ref"), 1, tree_j)
    tdir = tstore.save_checkpoint(str(tmp_path / "port"), 1, tree_t)
    jfiles = sorted(f for f in os.listdir(jdir) if f.endswith(".npy"))
    tfiles = sorted(f for f in os.listdir(tdir) if f.endswith(".npy"))
    assert jfiles == tfiles and len(tfiles) == len(tree_leaves(tree_t))
    for f in tfiles:
        a, b = np.load(os.path.join(jdir, f)), np.load(os.path.join(tdir, f))
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert a.tobytes() == b.tobytes(), f
    got, step = tstore.restore_checkpoint(str(tmp_path / "port"),
                                          device="cpu")
    assert step == 1 and isinstance(got["opt"], tadamw.AdamWState)
    for a, b in zip(tree_leaves(got), tree_leaves(tree_t)):
        assert torch.equal(a, b)
    back = convert.adamw_to_numpy(got["opt"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(a, np.asarray(b))
    ck = tstore.AsyncCheckpointer(str(tmp_path / "gc"))
    for s in range(1, 6):
        ck.save(s, tree_t)
    ck.wait()
    assert tstore.latest_step(str(tmp_path / "gc")) == 5
    assert sorted(os.listdir(tmp_path / "gc")) == [
        f"step_{s:010d}" for s in (3, 4, 5)]


def test_checkpoint_keeps_bf16_and_scalars(tmp_path):
    tree = {"w": torch.randn(3, 2).to(torch.bfloat16),
            "n": torch.tensor(7, dtype=torch.int32), "none": None,
            "l": [torch.arange(4)]}
    tstore.save_checkpoint(str(tmp_path), 2, tree)
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    got, step = tstore.restore_checkpoint(str(tmp_path), device="cpu")
    assert step == 2 and got["none"] is None
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b", "fm",
                                  "deepfm", "xdeepfm", "sasrec",
                                  "graphsage-reddit"])
def test_launch_train_main_on_cpu(tmp_path, arch):
    """``main`` with ``--device cpu`` for every family: finite losses and
    the loss's own metric; resumed from its step-2 checkpoint, the same
    bits as the run that was not interrupted."""
    ckpt = str(tmp_path / "ck")
    argv = ["--arch", arch, "--device", "cpu", "--steps", "4", "--batch",
            "4", "--seq", "16", "--log-every", "2", "--ckpt-dir", ckpt]
    pa, oa, la = ttrain.main(argv + ["--ckpt-every", "2"])
    assert all(np.isfinite(r["loss"]) for r in la) and len(la) == 2
    shutil.rmtree(os.path.join(ckpt, "step_0000000004"))
    pb, ob, lb = ttrain.main(argv + ["--ckpt-every", "100"])
    assert lb[-1]["loss"] == la[-1]["loss"]
    for a, b in zip(tree_leaves((pa, oa)), tree_leaves((pb, ob))):
        assert torch.equal(a, b)


def test_recsys_module_tree_is_the_references_layout():
    """``tree.module_tree``: the module's parameters in the reference's
    dict layout, so AdamW states and checkpoints line up."""
    from repro.models import recsys as jrec
    from repro_torch.models import recsys as trec
    for name in ("xdeepfm", "sasrec"):
        cfg = tconfigs.get_arch(name).smoke_config
        model = trec.init_recsys_params(torch.Generator().manual_seed(0),
                                        cfg, "cpu")
        tree = module_tree(model)
        ref = jrec.init_recsys_params(jax.random.PRNGKey(0),
                                      jconfigs.get_arch(name).smoke_config)
        assert tree_paths(tree) == tree_paths(_np_tree(ref))
        assert [tuple(t.shape) for t in tree_leaves(tree)] == [
            x.shape for x in jax.tree.leaves(ref)]
