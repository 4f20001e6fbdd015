"""Gradients in the port against the reference, on the CPU: the flash
attention's FlashAttention-2 backward, the dense LMs' ``lm_loss`` and the
recsys losses that ``launch.train`` steps on (GraphSAGE's are in
``test_torch_gnn.py``), and the MoE dispatch's: ``moe_ffn`` alone and the
MoE LMs' ``lm_loss``.

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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
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


@pytest.mark.parametrize("w_shape", [(16, 40), (3, 16, 40)])
def test_matmul_column_blocks_gradients(monkeypatch, w_shape):
    """``layers.matmul``'s CPU column blocks under autograd (a head [K, N]
    and an expert stack [E, K, N], 7 columns a block): the gradients of x
    and w those of one f64 product rounded once, to an f32 rounding."""
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.standard_normal(
        (w_shape[0] if len(w_shape) == 3 else 2, 5, 16)).astype(np.float32))
    w = torch.from_numpy(g.standard_normal(w_shape).astype(np.float32))
    cot = torch.from_numpy(g.standard_normal(
        x.shape[:-1] + (40,)).astype(np.float32))
    monkeypatch.setattr(tlayers, "CPU_F64_BLOCK",
                        8 * 7 * int(np.prod(w_shape[:-1])))

    def grads(fn):
        ins = [x.clone().requires_grad_(), w.clone().requires_grad_()]
        return torch.autograd.grad(fn(*ins), ins, cot)
    got = grads(tlayers.matmul)
    want = grads(lambda a, b: (a.double() @ b.double()).float())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-12b",
                                  "qwen3-moe-30b-a3b"])
def test_lm_layer_recompute_gives_equal_bits(monkeypatch, arch):
    """``lm_loss`` runs each layer under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of a group's body): the loss and every
    gradient equal, bit for bit, those of the layers run without the
    recompute (``checkpoint`` replaced by a plain call), and the forward
    keeps for the backward under a third of the bytes it keeps
    without."""
    cfg = tconfigs.get_arch(arch).smoke_config
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in next(
        jpipe.lm_token_stream(2, 64, cfg.vocab, seed=1)).items()}

    def run():
        held = []

        def pack(t):
            held.append(t.numel() * t.element_size())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = tsteps.loss_and_grads(
                lambda p, x: ttf.lm_loss(p, x["tokens"], x["targets"], cfg),
                params, b)
        return out, sum(held)
    (loss, m, grads), kept = run()
    monkeypatch.setattr(ttf, "checkpoint",
                        lambda fn, *a, **kw: fn(*a))
    (loss0, m0, grads0), kept0 = run()
    assert torch.equal(loss, loss0) and all(
        torch.equal(m[k], m0[k]) for k in m)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
    assert 3 * kept < kept0


def test_cin_recompute_gives_equal_bits(monkeypatch):
    """xDeepFM's CIN under autograd recomputes each chunk's outer products
    in the backward (``torch.utils.checkpoint``): with ``CIN_CHUNK_BYTES``
    forced down to 3 rows a chunk (11 chunks of 32 rows), the CIN term
    and the gradients of the CIN weights, its head and the embeddings
    equal, bit for bit, those of the same chunks run without the
    recompute; and the forward keeps for the backward under a tenth of
    the bytes of the products, which the plain chunks keep whole."""
    cfg = tconfigs.get_arch("xdeepfm").smoke_config
    model = trec.init_recsys_params(torch.Generator().manual_seed(0), cfg,
                                    "cpu")
    m, d = cfg.n_sparse, cfg.embed_dim
    monkeypatch.setattr(trec, "CIN_CHUNK_BYTES",
                        3 * 4 * d * max(cfg.cin_layers) * m)
    b = next(jpipe.click_stream(32, m, cfg.rows_per_field, seed=3))
    emb = trec.field_lookup(model.V.detach(), torch.from_numpy(b["ids"]),
                            cfg).requires_grad_()
    ws = [w.detach().requires_grad_() for w in model.cin]
    head = model.cin_head.detach().requires_grad_()
    rows = trec.cin_chunk_rows(ws, emb.shape)
    assert rows == 3
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(32)
                           .astype(np.float32))

    def saved_bytes(fn):
        held = []

        def pack(t):
            held.append(t.numel() * t.element_size())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn()
        return out, sum(held)
    got, kept = saved_bytes(lambda: trec._cin_apply(ws, head, emb))
    want, kept_plain = saved_bytes(lambda: torch.cat([
        trec._cin_rows(ws, head, emb[lo:lo + rows])
        for lo in range(0, 32, rows)]))
    assert torch.equal(got, want)
    inputs = ws + [head, emb]
    for a, b in zip(torch.autograd.grad(got, inputs, cot),
                    torch.autograd.grad(want, inputs, cot)):
        assert torch.equal(a, b)
    z_bytes = 32 * 4 * d * m * (m + sum(cfg.cin_layers[:-1]))
    assert kept_plain >= z_bytes > 10 * kept


def test_chip_smoke_lm_grads_check_runs_on_the_cpu():
    """``chip_smoke.lm_grads_card_vs_cpu`` with the CPU on both sides: the
    same bits, so an error of 0."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.lm_grads_card_vs_cpu("gemma3-12b", torch.device("cpu")) == 0


MOE_AUX_WEIGHT = 0.5       # large enough that the aux loss's share counts


@pytest.mark.parametrize("E,K,ng,cf,B,S,skew", [
    (8, 2, 4, 4.0, 2, 32, False),      # nothing dropped
    (8, 2, 4, 1.0, 2, 32, False),      # capacity 3: drops
    (4, 4, 2, 1.25, 2, 16, False),     # K == E
    (16, 2, 4, 1.25, 2, 16, False),    # 8 assignments a group, 16 experts
    (8, 2, 4, 1.0, 2, 48, True),       # skewed to experts 0, 1: many drops
    (16, 4, 3, 1.0, 3, 24, False),     # 3 groups of 8
])
def test_moe_ffn_grads_match_reference(E, K, ng, cf, B, S, skew):
    """``moe_ffn``'s gradients in x and in its four parameters (router,
    w_gate, w_up, w_down) against ``jax.value_and_grad`` of the
    reference's, for sum(out * cotangent) + 0.5 x aux: the router's
    through the top-K weights and the aux loss's ``me``, the dropped
    assignments' zero weights, and the slots no assignment fills (the
    port's hold a token row, the reference's zeros): every case leaves
    slots empty, and every case but K == E whole (group, expert) slot
    ranges."""
    D, F = 32, 40
    jc = jmoe.MoEConfig(E, K, D, F, cf, ng)
    tc = tmoe.MoEConfig(E, K, D, F, cf, ng)
    ref = {k: np.array(v) for k, v in jmoe.init_moe_params(
        jax.random.PRNGKey(E + K + S), jc, jnp.float32).items()}
    g = np.random.default_rng(S + ng)
    x = g.standard_normal((B, S, D)).astype(np.float32)
    if skew:
        ref["router"][0, :2] = (2.0, 1.5)
        x[..., 0] = 2.0
    cot = g.standard_normal((B, S, D)).astype(np.float32)

    def jl(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, jc)
        return jnp.sum(out * cot) + MOE_AUX_WEIGHT * aux
    jloss, (jgp, jgx) = jax.jit(jax.value_and_grad(jl, argnums=(0, 1)))(
        ref, jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()) for k, v in ref.items()}
    routes = []

    def tl(p, b):
        out, aux = tmoe.moe_ffn(p["moe"], p["x"], tc, routes)
        return (out * b).sum() + MOE_AUX_WEIGHT * aux, {}
    loss, _, grads = tsteps.loss_and_grads(
        tl, {"moe": tp, "x": torch.from_numpy(x)}, torch.from_numpy(cot))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _grads_close(grads, jax.tree.leaves({"moe": jgp, "x": jgx}))
    r = routes[0]
    n_s = tmoe.group_count(ng, S)
    filled = torch.zeros(B * n_s, E, dtype=torch.long)
    filled.scatter_add_(1, r.experts.reshape(B * n_s, -1),
                        r.kept.reshape(B * n_s, -1).long())
    assert bool((filled < tmoe.capacity(tc, S // n_s)).any())
    assert bool((filled == 0).any()) == (K < E)   # whole ranges empty
    dropped = int((~r.kept).sum())
    assert dropped > 0 if cf <= 1.0 else cf < 4.0 or dropped == 0
    if skew:
        assert dropped > B * S * K // 3


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_moe_lm_loss_grads_match_reference(arch):
    """A MoE LM's ``lm_loss`` (cross-entropy + 0.01 x aux) and every
    gradient, the routers' and the experts' included, against
    ``jax.value_and_grad`` of the reference's, leaf by leaf, at the
    smoke config (cf 4.0) over B 2 x S 48, and at cf 1.0, where the
    dispatch drops assignments."""
    jcfg = jconfigs.get_arch(arch).smoke_config
    tcfg = tconfigs.get_arch(arch).smoke_config
    jp = _redrawn_lm_params(jcfg)
    toks = np.random.default_rng(6).integers(1, jcfg.vocab, (2, 48)).astype(
        np.int32)
    tg = np.roll(toks, -1, axis=1)
    for cf in (jcfg.moe_cf, 1.0):
        jc = dataclasses.replace(jcfg, moe_cf=cf)
        tc = dataclasses.replace(tcfg, moe_cf=cf)
        (jloss, jm), jg = jax.jit(jax.value_and_grad(
            lambda p: jtf.lm_loss(p, jnp.asarray(toks), jnp.asarray(tg), jc),
            has_aux=True))(jp)
        tp = convert.lm_params(jp, tc, "cpu")
        loss, m, grads = tsteps.loss_and_grads(
            lambda p, b: ttf.lm_loss(p, b["tokens"], b["targets"], tc), tp,
            {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tg)})
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]),
                                   rtol=1e-5)
        assert float(m["aux"]) > 0
        assert tree_paths(tp) == tree_paths(jg)
        _grads_close(grads, jax.tree.leaves(jg))
