"""Gradient compression (``optim/compress.py``) in the port against the
reference, on the CPU.

* ``int8_compress`` on the reference's own noise (``jax.random.uniform``
  drawn here and passed to ``int8_compress_noise``): codes and scale bit
  for bit;
* ``int8_decompress``: the reference's formula, bit for bit;
* ``bf16_all_reduce`` over the shards' trees: the reference's function
  run under ``jax.vmap`` with a named axis (its ``psum``), bit for bit;
* ``int8_all_gather_reduce``: the reference's own accuracy test (8
  shards of ``np.linspace(-1, 1, 256)``, error < 0.02), every element
  within one quantization step of the exact mean, and unbiased: the mean
  of 4,000 draws within 5 standard errors of the exact mean.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.optim import compress as jcomp  # noqa: E402

from repro_torch.optim import compress as tcomp  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


@pytest.mark.parametrize("shape,seed", [((7,), 0), ((33, 5), 1),
                                        ((4, 3, 17), 2), ((1000,), 3),
                                        ((2, 2), 4)])
def test_int8_compress_bit_equal_on_reference_noise(shape, seed):
    g = (np.random.default_rng(seed).standard_normal(shape)
         * 10.0 ** (seed - 2)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    jq, js = jcomp.int8_compress(jnp.asarray(g), key)
    noise = np.array(jax.random.uniform(key, shape) - 0.5)
    tq, ts = tcomp.int8_compress_noise(torch.from_numpy(g),
                                       torch.from_numpy(noise))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(
        tcomp.int8_decompress(tq, ts).numpy(),
        np.asarray(jcomp.int8_decompress(jq, js)))


def test_int8_compress_zero_and_generator():
    """An all-zero leaf codes to zeros; ``int8_compress`` draws its noise
    from the generator given (two generators of one seed, equal codes)."""
    z = torch.zeros(9)
    q, s = tcomp.int8_compress(z, torch.Generator().manual_seed(0))
    assert not q.any() and s.item() == np.float32(1e-12)
    g = torch.randn(64, generator=torch.Generator().manual_seed(5))
    a = tcomp.int8_compress(g, torch.Generator().manual_seed(1))
    b = tcomp.int8_compress(g, torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[0].abs().max()) <= 127


def _shards(n, seed, dtype=np.float32):
    g = np.random.default_rng(seed)
    return [{"a": g.standard_normal((5, 3)).astype(dtype),
             "b": [g.standard_normal(7).astype(dtype) * 1e-3]}
            for _ in range(n)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_bf16_all_reduce_is_the_references(n):
    """The reference's ``bf16_all_reduce`` under ``jax.vmap`` over a named
    axis (its ``psum`` over n shards) against the port's over the list of
    the shards' trees: the same bits, the leaves' dtypes kept."""
    shards = _shards(n, n)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *shards)
    want = jax.vmap(lambda g: jcomp.bf16_all_reduce(g, "data"),
                    axis_name="data")(stacked)
    got = tcomp.bf16_all_reduce([tree_map(torch.from_numpy, s)
                                 for s in shards])
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert b.dtype == torch.float32
        for row in np.asarray(a):
            np.testing.assert_array_equal(b.numpy(), row)


def test_int8_all_gather_reduce_reference_accuracy():
    """The reference's own test: 8 shards of ``np.linspace(-1, 1, 256)``
    reshaped [8, 32], the mean within 0.02 of the exact one."""
    x = np.linspace(-1, 1, 8 * 32).astype(np.float32).reshape(8, 32)
    got = tcomp.int8_all_gather_reduce(
        [{"g": torch.from_numpy(r)} for r in x],
        torch.Generator().manual_seed(0))["g"]
    err = float(np.abs(got.numpy() - x.mean(0)).max())
    assert err < 0.02, err
    assert tcomp.int8_all_reduce is tcomp.int8_all_gather_reduce


@pytest.mark.parametrize("n", [2, 3, 8])
def test_int8_all_gather_reduce_within_one_step(n):
    """Every element of the int8 mean within one quantization step (the
    largest ``max|g_s| / 127`` of its leaf) of the exact f64 mean; a bf16
    leaf comes back bf16."""
    shards = _shards(n, 10 + n)
    gen = torch.Generator().manual_seed(n)
    got = tcomp.int8_all_gather_reduce(
        [tree_map(torch.from_numpy, s) for s in shards], gen)
    for k, leaf in enumerate(tree_leaves(got)):
        parts = [tree_leaves(s)[k].astype(np.float64) for s in shards]
        exact = sum(parts) / n
        step = max(np.abs(p).max() for p in parts) / 127
        assert np.abs(leaf.numpy() - exact).max() <= step
    bf = tcomp.int8_all_gather_reduce(
        [{"w": torch.from_numpy(s["a"]).bfloat16()} for s in shards], gen)
    assert bf["w"].dtype == torch.bfloat16


def test_int8_all_gather_reduce_is_unbiased():
    """The mean of 4,000 draws of the int8 mean is the exact mean within
    5 standard errors (the rounding's spread is at most half a step an
    element a shard)."""
    shards = _shards(2, 21)
    gen = torch.Generator().manual_seed(7)
    trees = [tree_map(torch.from_numpy, s) for s in shards]
    draws = 4000
    total = None
    for _ in range(draws):
        got = tree_leaves(tcomp.int8_all_gather_reduce(trees, gen))
        got = [g.double() for g in got]
        total = got if total is None else [a + b for a, b in zip(total,
                                                                 got)]
    for k, acc in enumerate(total):
        parts = [tree_leaves(s)[k].astype(np.float64) for s in shards]
        exact = sum(parts) / 2
        step = max(np.abs(p).max() for p in parts) / 127
        se = 0.5 * step / np.sqrt(draws)
        assert np.abs(acc.numpy() / draws - exact).max() < 5 * se
    q = [tcomp.int8_decompress(*tcomp.int8_compress(
        trees[0]["a"], gen)).double() for _ in range(draws)]
    step = float(np.abs(shards[0]["a"]).max()) / 127
    assert float((sum(q) / draws - trees[0]["a"].double()).abs().max()) < (
        5 * 0.5 * step / np.sqrt(draws))
