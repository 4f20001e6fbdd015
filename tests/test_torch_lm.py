"""The LM slices: the dense qwen3-14b, qwen2-1.5b and gemma3-12b and the
MoE mixtral-8x7b and qwen3-moe-30b-a3b serving in the port against the
reference, on the CPU at the smoke configs (whose capacity factor drops
no assignment; ``test_torch_moe.py`` holds the MoE FFN itself and the
models where capacity binds).

Reference parameters come from ``repro.models.transformer.init_params``
(``jax.random.PRNGKey(0)``) with their zero norms, norm scales and biases
redrawn (so those terms count) and cross to the port through
``convert.lm_params``; inputs are numpy draws from fixed seeds or
``lm_token_stream``.  Tolerances:

* layers in f32: rtol 1e-5, atol 1e-6 (the port's f32 products are f64
  products rounded once, the reference's f32 sums); swiglu also on an
  input of rms 3, where the reference's f32 products err past 1e-6: the
  port must be nearer an f64 evaluation than the reference; one bf16 case: rtol 1e-2, atol 1e-2 (a cast in the
  wrong place moves a value by ~2**-8 relative and more);
* ``rope`` at positions up to 524,287: rtol 1e-5, atol 1e-6 (the angles'
  frequencies are the reference's bits; ``sin``/``cos`` of angles up to
  5.2e5 differ by an ulp or so);
* models (logits, aux, caches, losses): rtol 1e-5, atol 1e-5 (logits within
  ~5); greedy tokens equal except where the reference's two logits lie
  within 1e-5 of each other;
* the port's decode against its own forward: 5e-4 absolute, the
  reference's ``test_decode_matches_forward`` bound;
* configs field for field, streams byte for byte, specs equal, the
  parameter round trip exact.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.data import pipelines as jpipe  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import steps as jsteps  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import common as tcommon  # noqa: E402
from repro_torch.data import pipelines as tpipe  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import steps as tsteps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["qwen3-14b", "qwen2-1.5b", "gemma3-12b"]
MOE = ["mixtral-8x7b", "qwen3-moe-30b-a3b"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().cpu().float() if isinstance(
        x, torch.Tensor) else x, dtype=np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or MODEL_TOL))


# ---------------------------------------------------------------------------
# Configs, cells, streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE + MOE)
def test_configs_field_for_field(name):
    ref, port = jconfigs.get_arch(name), tconfigs.get_arch(name)
    assert (port.name, port.family) == (ref.name, ref.family) == (name, "lm")
    for which in ("full_config", "smoke_config"):
        a, b = getattr(ref, which), getattr(port, which)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert b.n_groups == a.n_groups and b.is_moe == a.is_moe
        assert str(b.act_dtype).split(".")[-1] == a.act_dtype.name


@pytest.mark.parametrize("name", DENSE + MOE)
def test_param_counts(name):
    full = jconfigs.get_arch(name).full_config
    port = ttf.TransformerConfig(**dataclasses.asdict(full))
    assert port.param_count() == full.param_count()
    assert port.active_param_count() == full.active_param_count()


def _spec_tree(tree):
    """(shape, dtype name) leaves of a spec tree of either package."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_spec_tree(v) for v in tree]
    dt = tree.dtype
    name = (str(dt).split(".")[-1] if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)
    return (tuple(tree.shape), name)


@pytest.mark.parametrize("name", DENSE + MOE)
def test_lm_cells_and_cache_specs(name):
    ref, port = jconfigs.get_arch(name), tconfigs.get_arch(name)
    assert len(ref.cells) == len(port.cells) == 4
    for a, b in zip(ref.cells, port.cells):
        assert (a.shape, a.kind, a.meta, a.skip) == (
            b.shape, b.kind, b.meta, b.skip)
        assert _spec_tree(a.specs()) == _spec_tree(b.specs())
    assert bool(port.cell("long_500k").skip) == (
        name not in ("gemma3-12b", "mixtral-8x7b"))
    for cfg in (ref.full_config, ref.smoke_config):
        for batch, max_len in ((3, 40), (2, 5)):
            want = jtf.abstract_cache(cfg, batch, max_len)
            got = tcommon.cache_specs(
                ttf.TransformerConfig(**dataclasses.asdict(cfg)), batch,
                max_len)
            assert _spec_tree(want) == _spec_tree(got)


@pytest.mark.parametrize("seed", [0, 5])
def test_lm_token_stream_byte_equal(seed):
    a = jpipe.lm_token_stream(3, 64, 512, seed=seed, start_step=2)
    b = tpipe.lm_token_stream(3, 64, 512, seed=seed, start_step=2)
    for _ in range(2):
        x, y = next(a), next(b)
        for k in ("tokens", "targets"):
            assert x[k].dtype == y[k].dtype == np.int32
            assert x[k].tobytes() == y[k].tobytes()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_swiglu():
    g = np.random.default_rng(0)
    x = g.standard_normal((2, 7, 48)).astype(np.float32) * 3
    scale = g.standard_normal(48).astype(np.float32) * 0.1
    _close(tlayers.rms_norm(_t(x), _t(scale), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6),
           **LAYER_TOL)
    wg, wu = (g.standard_normal((48, 96)).astype(np.float32) * 0.15
              for _ in range(2))
    wd = g.standard_normal((96, 48)).astype(np.float32) * 0.1
    # swiglu's input in the model is rms_norm's output (unit rms)
    h = g.standard_normal((2, 7, 48)).astype(np.float32)
    _close(tlayers.swiglu(_t(h), _t(wg), _t(wu), _t(wd)),
           jlayers.swiglu(*(jnp.asarray(a) for a in (h, wg, wu, wd))),
           **LAYER_TOL)
    # The port's f32 products are f64 products rounded once: on a wider
    # input (rms 3) it is nearer an f64 evaluation than the reference's
    # f32 products are, whose own error there passes 1e-6.
    x64 = x.astype(np.float64)
    gate = x64 @ wg
    exact = (gate / (1 + np.exp(-gate)) * (x64 @ wu)) @ wd
    port = _np(tlayers.swiglu(_t(x), _t(wg), _t(wu), _t(wd)))
    ref = np.asarray(jlayers.swiglu(*(jnp.asarray(a)
                                      for a in (x, wg, wu, wd))))
    assert np.abs(port - exact).max() <= np.abs(ref - exact).max()
    np.testing.assert_allclose(port, exact, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dh", [16, 128, 256])
def test_rope_up_to_long_positions(dh):
    g = np.random.default_rng(dh)
    pos = np.concatenate([np.arange(64), np.arange(524_287 - 191, 524_288),
                          g.integers(0, 524_288, 64)]).astype(np.int32)
    x = g.standard_normal((2, pos.size, 3, dh)).astype(np.float32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos)[None], 1e6)
    _close(tlayers.rope(_t(x), _t(pos)[None], 1e6), want, **LAYER_TOL)
    # the frequencies are the reference's bits
    half = dh // 2
    jf = np.asarray(1e6 ** (-jnp.arange(0, half, dtype=jnp.float32) / half))
    np.testing.assert_array_equal(
        tlayers.rope_freq(half, 1e6, "cpu").numpy(), jf)


def _decode_case(g, B, W, KV, G, dh, fill, pos, window, dtype=np.float32):
    """Inputs of ``decode_attention``: the first ``fill`` writes of a ring
    of W slots up to position ``pos`` (slot p % W holds position p)."""
    q = g.standard_normal((B, 1, KV * G, dh)).astype(dtype)
    kc = g.standard_normal((B, W, KV, dh)).astype(dtype)
    vc = g.standard_normal((B, W, KV, dh)).astype(dtype)
    cpos = np.full(W, -1, np.int32)
    for p in range(max(0, pos + 1 - fill), pos + 1):
        cpos[p % W] = p
    return q, kc, vc, cpos


@pytest.mark.parametrize("W,fill,pos,window,B", [
    (16, 5, 4, 0, 2),       # empty slots
    (8, 8, 21, 0, 2),       # a wrapped ring
    (8, 8, 21, 5, 3),       # a window inside the ring
    (24, 24, 40, 10, 3),    # a window, the ring not yet wrapped twice
])
def test_decode_attention(W, fill, pos, window, B):
    """B 2 takes the products by sequence (B <= KV 2), B 3 by kv head."""
    g = np.random.default_rng(W + pos)
    q, kc, vc, cpos = _decode_case(g, B, W, 2, 3, 8, fill, pos, window)
    want = jlayers.decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, cpos)), jnp.int32(pos),
        window=window)
    got = tlayers.decode_attention(*(_t(a) for a in (q, kc, vc, cpos)),
                                   pos, window=window)
    _close(got, want, **LAYER_TOL)


@pytest.mark.parametrize("S,H,KV,window,q_chunk,kv_chunk", [
    (64, 6, 2, 0, 16, 16),
    (64, 6, 2, 0, 32, 16),        # q_chunk != kv_chunk, GQA groups 3
    (64, 4, 2, 0, 16, 32),
    (96, 4, 1, 20, 16, 32),       # a window shorter than S
    (128, 8, 2, 24, 32, 16),
    (128, 4, 2, 40, 64, 16),
    (64, 4, 4, 100, 16, 16),      # a window longer than S
    # q_chunk < kv_chunk, not a multiple: the reference's band ends before
    # a chunk's own diagonal block, so both packages leave it out
    (64, 4, 2, 8, 8, 16),
])
def test_chunked_attention(S, H, KV, window, q_chunk, kv_chunk):
    g = np.random.default_rng(S + H + window + q_chunk)
    B, dh = 2, 8
    q = g.standard_normal((B, S, H, dh)).astype(np.float32)
    k, v = (g.standard_normal((B, S, KV, dh)).astype(np.float32)
            for _ in range(2))
    kw = dict(window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    want = jlayers.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     **kw)
    _close(tlayers.chunked_attention(_t(q), _t(k), _t(v), **kw), want,
           **LAYER_TOL)


def test_block_plan_skips_only_masked_blocks():
    """Every (query chunk, kv block) pair in the reference's band with an
    unmasked (query, key) pair is visited once, in ascending block order
    per chunk; the plan's other band pairs are wholly masked."""
    for S, window, qc, kc in ((64, 0, 16, 16), (96, 20, 16, 32),
                              (128, 24, 32, 16), (64, 8, 8, 16)):
        _, band = tlayers._band_geometry(S, window, qc, kc)
        seen = {}
        for j, qa, qb in tlayers.block_plan(S, window, qc, kc):
            for qi in range(qa, qb):
                assert seen.get(qi, -1) < j
                seen[qi] = j
                start = tlayers._band_start(qi, S, band, qc, kc)
                assert start <= j * kc < start + band
        for qi in range(S // qc):
            start = tlayers._band_start(qi, S, band, qc, kc)
            visited = {j for j, qa, qb in tlayers.block_plan(S, window, qc,
                                                             kc)
                       if qa <= qi < qb}
            for j in range(start // kc, (start + band) // kc):
                m = tlayers._block_mask(
                    torch.arange(qi * qc, (qi + 1) * qc),
                    torch.arange(j * kc, (j + 1) * kc), window)
                assert (j in visited) == bool(m.any())


def test_layers_bf16():
    """bf16 operands: f32 scores and softmax, P cast to V's dtype, outputs
    cast back -- within 1e-2 of the reference."""
    g = np.random.default_rng(3)
    bf = jnp.bfloat16

    def pair(shape, s=1.0):
        x = (g.standard_normal(shape) * s).astype(np.float32)
        return jnp.asarray(x, bf), _t(x).to(torch.bfloat16)

    tol = dict(rtol=1e-2, atol=1e-2)
    (jx, tx), (js, ts) = pair((2, 32, 48), 2.0), pair((48,), 0.1)
    _close(tlayers.rms_norm(tx, ts.float()),
           jlayers.rms_norm(jx, js.astype(jnp.float32)), **tol)
    (jg, tg), (ju, tu), (jd, td) = (pair((48, 96), 0.15), pair((48, 96), 0.15),
                                    pair((96, 48), 0.1))
    _close(tlayers.swiglu(tx, tg, tu, td), jlayers.swiglu(jx, jg, ju, jd),
           **tol)
    (jq, tq), (jk, tk), (jv, tv) = (pair((2, 64, 4, 16)),
                                    pair((2, 64, 2, 16)),
                                    pair((2, 64, 2, 16)))
    pos = np.arange(64, dtype=np.int32)[None]
    _close(tlayers.rope(tq, _t(pos), 1e6),
           jlayers.rope(jq, jnp.asarray(pos), 1e6), **tol)
    for window in (0, 24):
        got = tlayers.chunked_attention(tq, tk, tv, window=window,
                                        q_chunk=16, kv_chunk=32)
        assert got.dtype == torch.bfloat16
        _close(got, jlayers.chunked_attention(jq, jk, jv, window=window,
                                              q_chunk=16, kv_chunk=32),
               **tol)
    cpos = np.arange(64, dtype=np.int32)
    got = tlayers.decode_attention(tq[:, -1:], tk, tv, _t(cpos), 63,
                                   window=24)
    assert got.dtype == torch.bfloat16
    _close(got, jlayers.decode_attention(jq[:, -1:], jk, jv,
                                         jnp.asarray(cpos), jnp.int32(63),
                                         window=24), **tol)


# ---------------------------------------------------------------------------
# The smoke models
# ---------------------------------------------------------------------------

def _ref_params(cfg):
    """The reference's parameters, its zero norms and biases redrawn."""
    params = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(0), cfg))
    g = np.random.default_rng(11)
    params["final_norm"] = (g.standard_normal(params["final_norm"].shape)
                            * 0.1).astype(np.float32)
    for bp in params["blocks"]:
        for name in ("ln1", "ln2", "qnorm", "knorm", "bq", "bk", "bv"):
            if name in bp:
                bp[name] = (g.standard_normal(bp[name].shape) * 0.1).astype(
                    bp[name].dtype)
    return params


@functools.lru_cache(maxsize=None)
def _jitted(cfg):
    fwd = jax.jit(functools.partial(jtf.forward, cfg=cfg,
                                    collect_cache=True))
    last = jax.jit(functools.partial(jtf.forward, cfg=cfg, last_only=True))
    dec = jax.jit(jtf.decode_step, static_argnums=(4,))
    return fwd, last, dec


@pytest.fixture(scope="module", params=DENSE + MOE)
def lm(request):
    """(name, reference cfg, reference params (numpy), port cfg, port
    params, tokens [2, 32])."""
    cfg = jconfigs.get_arch(request.param).smoke_config
    tcfg = tconfigs.get_arch(request.param).smoke_config
    params = _ref_params(cfg)
    toks = next(tpipe.lm_token_stream(2, 32, cfg.vocab, seed=3))["tokens"]
    return (request.param, cfg, params, tcfg,
            convert.lm_params(params, tcfg, "cpu"), toks)


def test_convert_round_trip(lm):
    name, cfg, params, tcfg, tparams, _ = lm
    back = convert.lm_to_numpy(tparams)
    flat = ttf.param_layout(tcfg)
    for key in flat:
        a, b = ttf.get_param(params, key), ttf.get_param(back, key)
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
        t = ttf.get_param(tparams, key)
        assert t.dtype == flat[key][1] and tuple(t.shape) == flat[key][0]
    again = convert.lm_params(back, tcfg, "cpu")
    for key in flat:
        assert torch.equal(ttf.get_param(again, key),
                           ttf.get_param(tparams, key))
    # bf16 leaves cross by their bits, and back through f32 exactly
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    jb = jax.tree_util.tree_map(np.asarray, jtf.init_params(
        jax.random.PRNGKey(1), dataclasses.replace(cfg, dtype="bfloat16")))
    tb = convert.lm_params(jb, bcfg, "cpu")
    assert tb["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tb["embed"].float().numpy(),
                                  np.asarray(jb["embed"], np.float32))
    tb2 = convert.lm_params(convert.lm_to_numpy(tb), bcfg, "cpu")
    for key in ttf.param_layout(bcfg):
        assert torch.equal(ttf.get_param(tb2, key), ttf.get_param(tb, key))


def test_forward_logits_and_caches(lm):
    name, cfg, params, tcfg, tparams, toks = lm
    fwd, last, _ = _jitted(cfg)
    want, waux, wcaches = fwd(params, jnp.asarray(toks))
    got, aux, caches = ttf.forward(tparams, _t(toks), tcfg,
                                   collect_cache=True)
    assert got.shape == (2, 32, cfg.vocab) and aux.dtype == torch.float32
    if cfg.is_moe:
        assert float(aux) > 0
        _close(aux, waux)
    else:
        assert float(aux) == 0.0
    _close(got, want)
    assert len(caches) == len(wcaches) == len(cfg.pattern)
    for a, b in zip(caches, wcaches):
        assert tuple(a["k"].shape) == b["k"].shape
        _close(a["k"], b["k"])
        _close(a["v"], b["v"])
        np.testing.assert_array_equal(a["pos"].numpy(), np.asarray(b["pos"]))
    got_last, _, none = ttf.forward(tparams, _t(toks), tcfg, last_only=True)
    assert none is None and got_last.shape == (2, 1, cfg.vocab)
    _close(got_last, last(params, jnp.asarray(toks))[0])


def test_lm_loss(lm):
    name, cfg, params, tcfg, tparams, toks = lm
    tg = np.roll(toks, -1, axis=1)
    want, wparts = jtf.lm_loss(params, jnp.asarray(toks), jnp.asarray(tg),
                               cfg)
    got, parts = ttf.lm_loss(tparams, _t(toks), _t(tg), tcfg)
    _close(got, want)
    _close(parts["ce"], wparts["ce"])
    _close(parts["aux"], wparts["aux"])


def test_decode_steps_logits_and_caches(lm):
    name, cfg, params, tcfg, tparams, toks = lm
    _, _, dec = _jitted(cfg)
    wc = jtf.init_cache(cfg, 2, 32)
    tc = ttf.init_cache(tcfg, 2, 32, "cpu")
    for t in range(32):
        want, wc = dec(params, wc, jnp.asarray(toks[:, t]), jnp.int32(t),
                       cfg)
        got, tc = ttf.decode_step(tparams, tc, _t(toks[:, t]), t, tcfg)
        _close(got, want)
    for a, b in zip(tc, wc):
        _close(a["k"], b["k"])
        _close(a["v"], b["v"])
        np.testing.assert_array_equal(a["pos"].numpy(), np.asarray(b["pos"]))


def _tokens_equal_off_near_ties(got, want, logits):
    got, want = np.asarray(got), np.asarray(want)
    lg = np.asarray(logits, np.float32)
    rows = np.nonzero(got != want)[0]
    assert np.all(np.abs(lg[rows, got[rows]] - lg[rows, want[rows]])
                  <= 1e-5), (got, want)


def test_serve_steps_and_cache_placement(lm):
    """Both packages' serve steps: prefill 32 tokens, place the caches with
    ``chip_smoke.place_caches`` into ``init_cache(2, 40)`` buffers, then 8
    greedy steps, each fed the reference's token."""
    name, cfg, params, tcfg, tparams, toks = lm
    cs = _chip_smoke()
    S, n = 32, 8
    jpre, jdec = jsteps.make_lm_prefill_step(cfg), jax.jit(
        jsteps.make_lm_decode_step(cfg))
    tpre, tdec = (tsteps.make_lm_prefill_step(tcfg),
                  tsteps.make_lm_decode_step(tcfg))
    want, wcaches = jpre(params, jnp.asarray(toks[:, :S]))
    got, caches = tpre(tparams, _t(toks[:, :S]))
    assert got.shape == (2, cfg.vocab)
    _close(got, want)
    for a, b in zip(caches, wcaches):
        _close(a["k"], b["k"])
        np.testing.assert_array_equal(a["pos"].numpy(), np.asarray(b["pos"]))
    tc = cs.place_caches(tcfg, caches, 2, S + n, "cpu")
    wc = [{k: jnp.asarray(_np(v) if k != "pos" else v.numpy())
           for k, v in c.items()} for c in cs.place_caches(
               tcfg, [{k: _t(np.asarray(v)) for k, v in c.items()}
                      for c in wcaches], 2, S + n, "cpu")]
    tok = np.asarray(jnp.argmax(want, -1), np.int32)
    for t in range(n):
        wt, wl, wc = jdec(params, wc, jnp.asarray(tok), jnp.int32(S + t))
        nt, lg, tc = tdec(tparams, tc, _t(tok), S + t)
        assert nt.dtype == torch.int32
        _close(lg, wl)
        _tokens_equal_off_near_ties(nt.numpy(), wt, wl)
        tok = np.asarray(wt)


@pytest.mark.parametrize("name", ["qwen3-14b", "qwen3-moe-30b-a3b"])
def test_chip_smoke_card_vs_cpu_names_the_side_that_moved(name, monkeypatch):
    """``chip_smoke.lm_card_vs_cpu``, the lm phase's (a), run with the CPU
    as both devices at the smoke config: it passes with equal weights;
    with the twin's head nudged by 1e-3 its prefill check fails, and the
    message's f64 evaluation (of the first device's weights) finds the
    first side within 1e-5 and the twin's off by more than 1e-4."""
    import re
    cs = _chip_smoke()
    cfg = dataclasses.replace(tconfigs.get_arch(name).smoke_config,
                              dtype="float32")
    out = cs.lm_card_vs_cpu(name, cfg, 32, 2, 0, "cpu")
    assert out["max_err"] == 0.0 and out["tokens_differing"] == 0
    to_cpu = cs._params_to

    def nudged(params, device):
        twin = to_cpu(params, device)
        twin["lm_head"] = twin["lm_head"] * (1 + 1e-3)
        return twin

    monkeypatch.setattr(cs, "_params_to", nudged)
    with pytest.raises(cs.PhaseError) as e:
        cs.lm_card_vs_cpu(name, cfg, 32, 2, 0, "cpu")
    msg = str(e.value)
    assert "prefill logits" in msg and "again differs by 0 (card) and 0 " \
        "(CPU)" in msg, msg
    m = re.search(r"the card errs (\S+) .*the CPU (\S+) ", msg)
    assert m and float(m[1]) < 1e-5 < 1e-4 < float(m[2]), msg


def test_place_caches_matches_token_by_token(lm):
    """``chip_smoke.place_caches`` of a prefill equals decoding every
    prompt token one at a time into the same buffers (a ring wrapped
    several times on gemma3's window of 8), and the next steps agree."""
    name, cfg, params, tcfg, tparams, _ = lm
    cs = _chip_smoke()
    S, n = 32, 6
    toks = next(tpipe.lm_token_stream(2, S + n, cfg.vocab, seed=4))["tokens"]
    _, pre = tsteps.make_lm_prefill_step(tcfg)(tparams, _t(toks[:, :S]))
    placed = cs.place_caches(tcfg, pre, 2, S + n, "cpu")
    stepped = ttf.init_cache(tcfg, 2, S + n, "cpu")
    for t in range(S):
        _, stepped = ttf.decode_step(tparams, stepped, _t(toks[:, t]), t,
                                     tcfg)
    for a, b in zip(placed, stepped):
        np.testing.assert_array_equal(a["pos"].numpy(), b["pos"].numpy())
        _close(a["k"], b["k"], rtol=5e-4, atol=5e-4)
        _close(a["v"], b["v"], rtol=5e-4, atol=5e-4)
    for t in range(S, S + n):
        la, placed = ttf.decode_step(tparams, placed, _t(toks[:, t]), t,
                                     tcfg)
        lb, stepped = ttf.decode_step(tparams, stepped, _t(toks[:, t]), t,
                                      tcfg)
        assert float((la - lb).abs().max()) < 5e-4


def test_port_decode_matches_its_forward(lm):
    """The reference's own test_decode_matches_forward, on the port."""
    name, cfg, params, tcfg, tparams, toks = lm
    logits, _, _ = ttf.forward(tparams, _t(toks), tcfg)
    caches = ttf.init_cache(tcfg, 2, 32, "cpu")
    for t in range(32):
        lg, caches = ttf.decode_step(tparams, caches, _t(toks[:, t]), t,
                                     tcfg)
    assert float((lg - logits[:, -1]).abs().max()) < 5e-4, name


def test_init_params_layout_and_determinism():
    cfg = tconfigs.get_arch("gemma3-12b").smoke_config
    a = ttf.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    b = ttf.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    ref = jtf.init_params(jax.random.PRNGKey(0),
                          jconfigs.get_arch("gemma3-12b").smoke_config)
    for key, (shape, dtype, std) in ttf.param_layout(cfg).items():
        t = ttf.get_param(a, key)
        assert tuple(t.shape) == tuple(ttf.get_param(ref, key).shape)
        assert t.dtype == dtype and torch.equal(t, ttf.get_param(b, key))
        if std is None:
            assert not t.any()
        else:
            assert abs(float(t.float().std()) / std - 1) < 0.2
