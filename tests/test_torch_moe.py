"""The MoE LM slice: the port's ``models/moe.py`` and the MoE archs
(mixtral-8x7b, qwen3-moe-30b-a3b) against the reference, on the CPU at
the smoke configs and small shapes.

Inputs are numpy draws from fixed seeds; the reference's parameters
(``init_moe_params`` / ``init_params`` at ``jax.random.PRNGKey``) cross
to the port as numpy arrays (``convert.lm_params`` for whole models).
Tolerances:

* ``moe_ffn`` in f32: rtol 1e-5, atol 1e-6 (the port's f32 products are
  f64 products rounded once, the reference's f32 sums); one bf16 case at
  rtol 1e-2, atol 1e-2; routing decisions (experts, drops) equal;
* models (logits, aux, caches): rtol 1e-5, atol 1e-5, as
  ``test_torch_lm.py``; the port's decode against its own no-drop
  forward: 5e-4 absolute, the reference's ``test_decode_matches_forward``
  bound.

The smoke configs' capacity factor (4.0) drops nothing; here capacity
binds: a tie fixture (a zero router: equal probabilities, every token
takes experts 0..K-1) and a drop fixture (cf 1.0, a router skewed to
experts 0 and 1) with a known count of dropped assignments, and the two
smoke models at cf 1.0.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process (several run at once).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import pipelines as tpipe  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

MOE = ["mixtral-8x7b", "qwen3-moe-30b-a3b"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x.detach().cpu().float() if isinstance(
        x, torch.Tensor) else x, dtype=np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or MODEL_TOL))


def _cfgs(E, K, D, F, cf, ng):
    return (jmoe.MoEConfig(E, K, D, F, cf, ng),
            tmoe.MoEConfig(E, K, D, F, cf, ng))


def _params(jcfg, seed=1, dtype=jnp.float32):
    """The reference's MoE parameters as numpy arrays (bf16 widened to
    f32), and the same as the port's tensors in their layout's dtypes."""
    ref = {k: np.asarray(v) for k, v in jmoe.init_moe_params(
        jax.random.PRNGKey(seed), jcfg, dtype).items()}
    layout = tmoe.moe_layout(
        tmoe.MoEConfig(jcfg.n_experts, jcfg.top_k, jcfg.d_model, jcfg.d_ff),
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    port = {k: torch.from_numpy(np.array(v, np.float32)).to(layout[k][1])
            for k, v in ref.items()}
    return ref, port


def _run(ref, port, x, jcfg, tcfg):
    """Both packages' ``moe_ffn`` on x; the port's ``Routing``."""
    want, waux = jmoe.moe_ffn(ref, jnp.asarray(x), jcfg)
    routes = []
    got, aux = tmoe.moe_ffn(port, torch.from_numpy(np.array(x)), tcfg,
                            routes)
    assert len(routes) == 1
    return (got, aux), (want, waux), routes[0]


# ---------------------------------------------------------------------------
# Config helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_moe_cfg_and_capacity(name):
    """``moe_cfg(S)`` and ``capacity`` equal the reference's for the full
    and smoke configs at the cells' lengths, odd lengths and decode's 1;
    qwen3-moe at S 32,768: 16 groups of 2,048, C 161; mixtral C 641; a
    decode step one group of one token, C = K at the full configs."""
    arch = jconfigs.get_arch(name)
    for jc in (arch.full_config, arch.smoke_config):
        tc = ttf.TransformerConfig(**dataclasses.asdict(jc))
        for S in (1, 7, 12, 32, 96, 256, 4096, 32768, 524288):
            a, b = jc.moe_cfg(S), tc.moe_cfg(S)
            assert (a.n_experts, a.top_k, a.d_model, a.d_ff, a.n_groups,
                    a.capacity_factor) == (b.n_experts, b.top_k, b.d_model,
                                           b.d_ff, b.n_groups,
                                           b.capacity_factor)
            assert b.router_dtype == torch.float32
            Sg = S // b.n_groups
            assert tmoe.capacity(b, Sg) == jmoe.capacity(a, Sg)
        # one token's K distinct experts fill one slot each: no drop
        one = tc.moe_cfg(1)
        assert one.n_groups == 1 and tmoe.capacity(one, 1) >= 1
    full = ttf.TransformerConfig(**dataclasses.asdict(arch.full_config))
    assert tmoe.capacity(full.moe_cfg(1), 1) == full.moe_top_k
    c = full.moe_cfg(32768)
    assert (c.n_groups, tmoe.capacity(c, 2048)) == (
        16, {"qwen3-moe-30b-a3b": 161, "mixtral-8x7b": 641}[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layout_matches_reference_init(dtype):
    """Names, shapes and dtypes of ``moe_layout``: the router f32 in a bf16
    model, the experts in the model's dtype."""
    jc, tc = _cfgs(8, 2, 64, 96, 1.25, 4)
    ref = jmoe.init_moe_params(jax.random.PRNGKey(0), jc,
                               getattr(jnp, dtype))
    layout = tmoe.moe_layout(tc, getattr(torch, dtype))
    assert set(layout) == set(ref)
    for name, (shape, dt, std) in layout.items():
        assert tuple(shape) == ref[name].shape
        assert str(dt).split(".")[-1] == ref[name].dtype.name
        assert std == pytest.approx(float(np.asarray(
            ref[name], np.float32).std()), rel=0.1)
    assert layout["router"][1] == torch.float32


def test_batched_matmul_blocks_columns(monkeypatch):
    """``layers.matmul`` on an expert stack [E, K, N]: the CPU's f64 column
    blocks give the bits of one f64 product rounded once."""
    g = np.random.default_rng(2)
    x = torch.from_numpy(g.standard_normal((3, 5, 16)).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((3, 16, 40)).astype(np.float32))
    whole = (x.double() @ w.double()).float()
    assert torch.equal(tlayers.matmul(x, w), whole)
    monkeypatch.setattr(tlayers, "CPU_F64_BLOCK", 8 * 3 * 16 * 7)  # 7 cols
    assert torch.equal(tlayers.matmul(x, w), whole)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,K,D,F,ng,cf,B,S", [
    (8, 2, 64, 96, 4, 1.25, 2, 32),
    (8, 2, 64, 96, 4, 1.0, 2, 32),      # capacity 5 of 8 slots' worth
    (16, 4, 32, 48, 3, 1.0, 3, 24),     # 3 groups of 8
    (4, 2, 32, 40, 4, 1.25, 2, 10),     # groups lowered to 2 (10 % 4)
    (8, 8, 32, 40, 2, 1.25, 2, 16),     # K == E
    (4, 2, 32, 40, 16, 1.25, 3, 1),     # a decode step: C = K
])
def test_moe_ffn_matches_reference(E, K, D, F, ng, cf, B, S):
    jc, tc = _cfgs(E, K, D, F, cf, ng)
    ref, port = _params(jc, seed=E + K + S)
    x = np.random.default_rng(S + ng).standard_normal(
        (B, S, D)).astype(np.float32)
    (got, aux), (want, waux), r = _run(ref, port, x, jc, tc)
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    _close(got, want, **LAYER_TOL)
    _close(aux, waux, **LAYER_TOL)
    assert r.experts.shape == r.kept.shape == (B, S, K)
    if S == 1:
        assert bool(r.kept.all())                  # decode never drops


def test_moe_ffn_ties_take_lowest_experts():
    """A zero router: every probability is 1/E, so every token takes
    experts 0..K-1 with weight 1/K; each of those experts gets all Sg
    tokens of a group and keeps the first C, the later tokens drop."""
    E, K, D, F, ng, cf, B, S = 8, 2, 32, 40, 2, 1.25, 2, 32
    jc, tc = _cfgs(E, K, D, F, cf, ng)
    ref, port = _params(jc)
    ref["router"] = np.zeros_like(ref["router"])
    port["router"] = torch.zeros_like(port["router"])
    x = np.random.default_rng(0).standard_normal(
        (B, S, D)).astype(np.float32)
    (got, aux), (want, waux), r = _run(ref, port, x, jc, tc)
    _close(got, want, **LAYER_TOL)
    _close(aux, waux, **LAYER_TOL)
    Sg = S // ng
    C = tmoe.capacity(tc, Sg)
    assert C < Sg                                   # capacity binds
    assert torch.equal(r.experts, torch.arange(K).expand(B, S, K))
    in_group = torch.arange(S) % Sg
    assert torch.equal(r.kept, (in_group < C)[None, :, None].expand(
        B, S, K))
    assert int((~r.kept).sum()) == B * ng * K * (Sg - C)
    assert bool((r.margin == 0).all())
    # a dropped token's output is zero: both its assignments dropped
    assert not got[:, Sg - 1].any() and got[:, 0].abs().sum() > 0


def test_moe_ffn_drops_known_count():
    """cf 1.0 and a router skewed to experts 0 and 1 (through a constant
    feature: logits ~40 and ~24 against ~1 for the others): every token's
    top 2 are experts 0 and 1, each keeps C of a
    group's Sg tokens, so B * groups * 2 * (Sg - C) assignments drop; the
    outputs equal the reference's."""
    E, K, D, F, ng, cf, B, S = 8, 2, 32, 40, 4, 1.0, 2, 48
    jc, tc = _cfgs(E, K, D, F, cf, ng)
    ref, port = _params(jc, seed=3)
    ref["router"] = ref["router"].copy()
    ref["router"][0, :2] = (20.0, 12.0)
    port["router"] = torch.from_numpy(ref["router"].copy())
    x = np.random.default_rng(4).standard_normal(
        (B, S, D)).astype(np.float32)
    x[..., 0] = 2.0
    (got, aux), (want, waux), r = _run(ref, port, x, jc, tc)
    _close(got, want, **LAYER_TOL)
    _close(aux, waux, **LAYER_TOL)
    Sg = S // ng
    C = tmoe.capacity(tc, Sg)
    assert C == 4 and torch.equal(r.experts,
                                  torch.tensor([0, 1]).expand(B, S, K))
    assert int((~r.kept).sum()) == B * ng * K * (Sg - C)


def test_moe_ffn_bf16():
    """bf16 activations and experts, the router f32: within 1e-2."""
    jc, tc = _cfgs(8, 2, 64, 96, 1.25, 4)
    ref, port = _params(jc, seed=5, dtype=jnp.bfloat16)
    assert port["router"].dtype == torch.float32
    assert port["w_gate"].dtype == torch.bfloat16
    x = np.random.default_rng(6).standard_normal(
        (2, 32, 64)).astype(np.float32)
    want, waux = jmoe.moe_ffn(ref, jnp.asarray(x, jnp.bfloat16), jc)
    got, aux = tmoe.moe_ffn(port, torch.from_numpy(x).bfloat16(), tc)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _close(got, want, rtol=1e-2, atol=1e-2)
    _close(aux, waux, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The smoke models where capacity binds
# ---------------------------------------------------------------------------

def _ref_params(cfg):
    """The reference's parameters (numpy), zero norms redrawn."""
    params = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(0), cfg))
    g = np.random.default_rng(11)
    params["final_norm"] = (g.standard_normal(params["final_norm"].shape)
                            * 0.1).astype(np.float32)
    for bp in params["blocks"]:
        for name in ("ln1", "ln2", "qnorm", "knorm"):
            if name in bp:
                bp[name] = (g.standard_normal(bp[name].shape) * 0.1).astype(
                    np.float32)
    return params


@functools.lru_cache(maxsize=None)
def _jitted(cfg):
    fwd = jax.jit(functools.partial(jtf.forward, cfg=cfg,
                                    collect_cache=True))
    dec = jax.jit(jtf.decode_step, static_argnums=(4,))
    return fwd, dec


@pytest.fixture(scope="module", params=MOE)
def dropping(request):
    """(reference cfg, reference params, port cfg, port params, tokens
    [2, 32]) of the arch's smoke config at cf 1.0, where the forward
    drops assignments."""
    jc = dataclasses.replace(jconfigs.get_arch(request.param).smoke_config,
                             moe_cf=1.0)
    tc = dataclasses.replace(tconfigs.get_arch(request.param).smoke_config,
                             moe_cf=1.0)
    params = _ref_params(jc)
    toks = next(tpipe.lm_token_stream(2, 32, jc.vocab, seed=8))["tokens"]
    return jc, params, tc, convert.lm_params(params, tc, "cpu"), toks


def test_forward_with_drops_and_decode_match_reference(dropping):
    """Forward (logits, aux, every cache) where capacity drops, then 32
    decode steps (logits and caches), against the reference."""
    jc, params, tc, tparams, toks = dropping
    fwd, dec = _jitted(jc)
    want, waux, wcaches = fwd(params, jnp.asarray(toks))
    routes = []
    got, aux, caches = ttf.forward(tparams, torch.from_numpy(toks), tc,
                                   collect_cache=True, routing=routes)
    assert len(routes) == tc.n_layers
    assert sum(int((~r.kept).sum()) for r in routes) > 0
    _close(got, want)
    _close(aux, waux)
    for a, b in zip(caches, wcaches):
        _close(a["k"], b["k"])
        _close(a["v"], b["v"])
        np.testing.assert_array_equal(a["pos"].numpy(), np.asarray(b["pos"]))
    wc = jtf.init_cache(jc, 2, 32)
    tcache = ttf.init_cache(tc, 2, 32, "cpu")
    for t in range(32):
        want, wc = dec(params, wc, jnp.asarray(toks[:, t]), jnp.int32(t),
                       jc)
        routes = []
        got, tcache = ttf.decode_step(tparams, tcache,
                                      torch.from_numpy(toks[:, t]), t, tc,
                                      routing=routes)
        assert all(bool(r.kept.all()) for r in routes)
        _close(got, want)
    for a, b in zip(tcache, wc):
        _close(a["k"], b["k"])
        _close(a["v"], b["v"])


def test_decode_matches_no_drop_forward(dropping):
    """Decode never drops: 32 steps equal the forward of the same weights
    at a capacity factor (E / K) where no assignment drops, to 5e-4; the
    cf 1.0 forward drops some (decode is not held against it)."""
    jc, params, tc, tparams, toks = dropping
    t = torch.from_numpy(toks)
    no_drop = dataclasses.replace(tc, moe_cf=tc.moe_experts / tc.moe_top_k)
    routes = []
    logits, _, _ = ttf.forward(tparams, t, no_drop, routing=routes)
    assert all(bool(r.kept.all()) for r in routes)
    routes = []
    ttf.forward(tparams, t, tc, routing=routes)
    assert sum(int((~r.kept).sum()) for r in routes) > 0
    caches = ttf.init_cache(tc, 2, 32, "cpu")
    for i in range(32):
        lg, caches = ttf.decode_step(tparams, caches, t[:, i], i, tc)
    assert float((lg - logits[:, -1]).abs().max()) < 5e-4


@pytest.mark.parametrize("name", MOE)
def test_init_params_moe_layout(name):
    """``init_params`` of the bf16 smoke model: the router f32, the expert
    stacks bf16 [n_groups, E, ...], the reference's shapes and scales."""
    cfg = dataclasses.replace(tconfigs.get_arch(name).smoke_config,
                              dtype="bfloat16")
    a = ttf.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    ref = jtf.init_params(jax.random.PRNGKey(0), dataclasses.replace(
        jconfigs.get_arch(name).smoke_config, dtype="bfloat16"))
    moe = a["blocks"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_down"].dtype == torch.bfloat16
    assert "w_gate" not in a["blocks"][0]
    for key, (shape, dtype, std) in ttf.param_layout(cfg).items():
        t = ttf.get_param(a, key)
        assert tuple(t.shape) == tuple(ttf.get_param(ref, key).shape)
        assert t.dtype == dtype
        if std is not None:
            assert abs(float(t.float().std()) / std - 1) < 0.2
    names = [n for n, _ in ttf.param_items(a)]
    assert sorted(names) == sorted(ttf.param_layout(cfg))


def test_chip_smoke_routes_vs_cpu():
    """``chip_smoke._routes_vs_cpu``, (a)'s routing check: a top-K set may
    differ only at a near tie (counted, its batch row left out of the
    logits check) and may move drops within its own dispatch group only."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = tconfigs.get_arch("qwen3-moe-30b-a3b").smoke_config
    B, S, K = 2, 32, cfg.moe_top_k                 # 4 groups of 8
    g = torch.Generator().manual_seed(0)
    experts = torch.stack([torch.randperm(cfg.moe_experts, generator=g)[:K]
                           for _ in range(B * S)]).view(B, S, K)
    kept = torch.rand(B, S, K, generator=g) < 0.8
    margin = torch.full((B, S), 1e-2)
    margin[1, 9] = 1e-6                            # a near tie, group 1
    cpu = [tmoe.Routing(experts, kept, margin)]
    assert cs._routes_vs_cpu(cpu, cpu, cfg, B, S, "same")[0] == 0
    def other(b, s):                               # an expert not chosen
        return next(e for e in range(cfg.moe_experts)
                    if e not in experts[b, s].tolist())

    swapped = experts.clone()
    swapped[1, 9, 0] = other(1, 9)
    moved = kept.clone()
    moved[1, 12] = ~moved[1, 12]                   # same group: allowed
    n, rows, dropped = cs._routes_vs_cpu(
        [tmoe.Routing(swapped, moved, margin)], cpu, cfg, B, S, "tie")
    assert (n, rows.tolist(), dropped) == (1, [False, True],
                                           int((~kept).sum()))
    moved[1, 17] = ~moved[1, 17]                   # group 2: not allowed
    with pytest.raises(cs.PhaseError, match="drop masks"):
        cs._routes_vs_cpu([tmoe.Routing(swapped, moved, margin)], cpu, cfg,
                          B, S, "drops")
    far = experts.clone()
    far[0, 3, 0] = other(0, 3)
    with pytest.raises(cs.PhaseError, match="near ties"):
        cs._routes_vs_cpu([tmoe.Routing(far, kept, margin)], cpu, cfg, B, S,
                          "far")
