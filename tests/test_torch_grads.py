"""Gradients in the port against the reference, on the CPU: the flash
attention's FlashAttention-2 backward, the dense LMs' ``lm_loss`` and the
recsys losses that ``launch.train`` steps on (GraphSAGE's are in
``test_torch_gnn.py``); a MoE LM's gradients raise.

Tolerances:

* gradients against ``jax.value_and_grad`` of the reference's loss: rtol
  1e-4, atol 1e-6 x the leaf's max |g|; the loss rtol 1e-5.  For the LMs
  the port's gradients are also evaluated in f64, and an element may miss
  the reference by up to twice that where the port is the nearer to the
  f64 value (``_grads_close``);
* ``chunked_attention``'s backward in f64: ``torch.autograd.gradcheck``,
  and against autograd through a plain masked softmax attention, rtol
  1e-10, atol 1e-12.
"""
import dataclasses
import importlib.util
from pathlib import Path

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
from repro.models import recsys as jrec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402
from repro_torch.tree import module_tree, tree_map, tree_paths  # noqa: E402


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


GRAD_RTOL = 1e-4


def _grad_tol(w):
    return GRAD_RTOL * np.abs(w) + 1e-6 * float(np.abs(w).max())


def _grads_close(got, want, truth=None):
    """Leaf by leaf: rtol 1e-4, atol 1e-6 x the reference leaf's max |g|.

    With ``truth`` (the port's gradients evaluated in f64), an element
    may miss the reference by up to twice that only where the reference's
    own f32 rounding is the larger error: there the port must be nearer
    the f64 value than the reference; and every element of the port must
    lie within the tolerance of the f64 value.  (The f64 value comes from
    the port's own code, so it excuses a rounding-sized miss and no
    more.)"""
    want = [np.asarray(w, dtype=np.float32) for w in want]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        g = g.detach().float().numpy()
        if truth is None:
            np.testing.assert_allclose(
                g, w, rtol=GRAD_RTOL,
                atol=1e-6 * max(float(np.abs(w).max()), 1e-30),
                err_msg=f"leaf {i}")
            continue
        t = truth[i].detach().numpy()
        assert (np.abs(g - t) <= _grad_tol(t)).all(), (
            f"leaf {i}: the port off the f64 gradients by "
            f"{np.abs(g - t).max():.3g}")
        miss, tol = np.abs(g - w), _grad_tol(w)
        assert (miss <= 2 * tol).all(), (
            f"leaf {i}: off the reference by {(miss / tol).max():.3g} x "
            f"the tolerance")
        off = miss > tol
        assert (np.abs(g - t)[off] < np.abs(w - t)[off]).all(), (
            f"leaf {i}: {int(off.sum())} elements off the reference, the "
            f"port not nearer the f64 gradients there")


def _plain_attention(q, k, v, window):
    """Softmax attention with the causal / window mask, through autograd:
    q [B, S, H, dh], k/v [B, S, KV, dh], head h on kv head h // G."""
    S, G = q.shape[1], q.shape[2] // k.shape[2]
    k, v = (x.repeat_interleave(G, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    pos = torch.arange(S)
    ok = pos[None, :] <= pos[:, None]
    if window:
        ok &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~ok, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("S,H,KV,window,q_chunk,kv_chunk", [
    (32, 4, 2, 0, 8, 8),          # 4 kv blocks, the upper ones skipped
    (32, 2, 1, 0, 16, 8),         # q_chunk != kv_chunk, GQA groups 2
    (32, 4, 2, 6, 8, 8),          # a window: blocks before it skipped
    (32, 2, 2, 10, 8, 16),        # a window over q_chunk < kv_chunk
])
def test_chunked_attention_backward_f64(S, H, KV, window, q_chunk,
                                        kv_chunk):
    """The FlashAttention-2 backward over several kv blocks and query
    chunks, with skipped blocks and a window: ``gradcheck`` in f64, and
    the same gradients as autograd through a plain masked softmax."""
    g = np.random.default_rng(S + H + window + q_chunk)
    B, dh = 1, 4
    q = torch.from_numpy(g.standard_normal((B, S, H, dh)))
    k, v = (torch.from_numpy(g.standard_normal((B, S, KV, dh)))
            for _ in range(2))
    kw = dict(window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
              p_dtype="float64")
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda *x: tlayers.chunked_attention(*x, **kw), ins)
    out = tlayers.chunked_attention(*ins, **kw)
    assert out.dtype == torch.float64
    cot = torch.from_numpy(g.standard_normal(out.shape))
    got = torch.autograd.grad(out, ins, cot)
    ref_ins = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = _plain_attention(*ref_ins, window)
    torch.testing.assert_close(out, ref, rtol=1e-10, atol=1e-12)
    want = torch.autograd.grad(ref, ref_ins, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def _redrawn_lm_params(cfg):
    """The reference's parameters, its zero norms and biases redrawn so
    their gradients' paths count."""
    params = _np_tree(jtf.init_params(jax.random.PRNGKey(0), cfg))
    g = np.random.default_rng(11)
    params["final_norm"] = (g.standard_normal(params["final_norm"].shape)
                            * 0.1).astype(np.float32)
    for bp in params["blocks"]:
        for name in ("ln1", "ln2", "qnorm", "knorm", "bq", "bk", "bv"):
            if name in bp:
                bp[name] = (g.standard_normal(bp[name].shape) * 0.1).astype(
                    bp[name].dtype)
    return params


@pytest.mark.parametrize("arch,S", [
    ("qwen2-1.5b", 64),           # full causal, 4 kv blocks of 16
    ("gemma3-12b", 64),           # five windowed 'l' layers (window 8)
])
def test_lm_loss_grads_match_reference(arch, S):
    """``lm_loss``'s gradients through the port's flash backward against
    ``jax.value_and_grad`` of the reference's ``lm_loss``, leaf by leaf,
    at S 64 with chunks of 16: the backward sums dq over kv blocks and
    dk/dv over query chunks, skips wholly masked blocks and, for gemma3,
    masks the window.

    The port's gradients are also evaluated in f64 (the same parameters,
    the model run in f64): through gemma3's six layers the reference's
    f32 gradients stray from that by up to 1.09 x the tolerance
    (``blocks.3.knorm``) and the port's by up to 0.60 x, the port's rms
    error half the reference's on every leaf; so where the two f32
    gradients differ by more than the tolerance the port must be the
    nearer to f64 (``_grads_close``)."""
    jcfg = jconfigs.get_arch(arch).smoke_config
    tcfg = tconfigs.get_arch(arch).smoke_config
    assert (tcfg.q_chunk, tcfg.kv_chunk) == (16, 16)
    jp = _redrawn_lm_params(jcfg)
    tp = convert.lm_params(jp, tcfg, "cpu")
    toks = np.random.default_rng(5).integers(1, jcfg.vocab, (2, S)).astype(
        np.int32)
    tg = np.roll(toks, -1, axis=1)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jnp.asarray(toks), jnp.asarray(tg), jcfg),
        has_aux=True))(jp)
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tg)}

    def grads_of(cfg, params):
        return tsteps.loss_and_grads(
            lambda p, b: ttf.lm_loss(p, b["tokens"], b["targets"], cfg),
            params, batch)
    loss, _, grads = grads_of(tcfg, tp)
    loss64, _, truth = grads_of(
        dataclasses.replace(tcfg, dtype="float64", attn_p_dtype="float64"),
        tree_map(lambda t: t.double(), tp))
    assert truth[0].dtype == torch.float64
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(loss64), rtol=1e-5)
    assert tree_paths(tp) == tree_paths(jg)
    _grads_close(grads, jax.tree.leaves(jg), truth)


@pytest.mark.parametrize("kind", ["fm", "deepfm", "xdeepfm", "sasrec"])
def test_recsys_loss_grads_match_reference(kind):
    """The gradients ``launch.train`` steps on for each recsys family
    (through ``functional_call`` on the module) against ``jax.grad`` of
    the reference's loss, leaf by leaf."""
    cfg = jconfigs.get_arch(kind).smoke_config
    tcfg = tconfigs.get_arch(kind).smoke_config
    jp = jrec.init_recsys_params(jax.random.PRNGKey(0), cfg)
    model = convert.recsys_model(_np_tree(jp), tcfg, "cpu")
    if kind == "sasrec":
        b = next(jpipe.sasrec_stream(16, cfg.seq_len, cfg.n_items, seed=2))

        def jl(p):
            return jrec.sasrec_loss(p, b["seq"], b["pos"], b["neg"], cfg)

        def fn(m, tb):
            return (trec.sasrec_loss(m, tb["seq"], tb["pos"], tb["neg"],
                                     tcfg), {})
    else:
        b = next(jpipe.click_stream(16, cfg.n_sparse, cfg.rows_per_field,
                                    seed=2))

        def jl(p):
            return jrec.recsys_loss(p, b["ids"], b["labels"], cfg)

        def fn(m, tb):
            return trec.recsys_loss(m, tb["ids"], tb["labels"], tcfg), {}
    jloss, jg = jax.value_and_grad(jl)(jp)
    tree = module_tree(model)
    loss, _, grads = tsteps.loss_and_grads(
        ttrain.module_loss(model, fn), tree,
        tree_map(torch.from_numpy, dict(b)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert tree_paths(tree) == tree_paths(_np_tree(jg))
    _grads_close(grads, jax.tree.leaves(jg))


def test_chip_smoke_lm_grads_check_runs_on_the_cpu():
    """``chip_smoke.lm_grads_card_vs_cpu`` with the CPU on both sides: the
    same bits, so an error of 0."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.lm_grads_card_vs_cpu("gemma3-12b", torch.device("cpu")) == 0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_moe_lm_gradients_raise(arch):
    """A MoE LM's gradients are not ported: a train step raises and names
    the ROADMAP item; the loss's value still comes."""
    params, step, stream = ttrain.build_smoke_trainer(arch, 2, 16, 1e-3,
                                                      device="cpu")
    batch = tree_map(torch.from_numpy, next(stream(0)))
    with pytest.raises(NotImplementedError, match="item 7"):
        step(params, tadamw.adamw_init(params), batch)
    cfg = tconfigs.get_arch(arch).smoke_config
    loss, _ = ttf.lm_loss(params, batch["tokens"], batch["targets"], cfg)
    assert torch.isfinite(loss)
