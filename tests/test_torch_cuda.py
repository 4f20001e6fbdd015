"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU: it
is marked ``cuda`` and skips without one.  On a machine with the card and
the CUDA toolkit (JAX is not needed; ``--noconftest`` skips the JAX
fixtures of ``tests/conftest.py``):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Integer-valued inputs make every f32 sum exact, so kernel and plain
version must be equal; the frontier step and the row gather are compared
bit for bit on any input.  ``chip_smoke.py`` repeats these checks at the main path's shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _t(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


@pytest.mark.parametrize("d", [128, 24, 7])
def test_l2_rows_exact_on_integers(dev, d):
    g = np.random.default_rng(d)
    q = _t(g.integers(-4, 5, (9, d)).astype(np.float32), dev)
    table = _t(g.integers(-4, 5, (300, d)).astype(np.float32), dev)
    ids_np = g.integers(-1, 300, (9, 70)).astype(np.int32)
    ids = _t(ids_np, dev)
    assert torch.equal(ops.l2_rows(q, table, ids),
                       ref.l2_rows_ref(q, table, ids))


@pytest.mark.parametrize("m,ksub", [(32, 256), (8, 16), (5, 200)])
def test_adc_rows_exact_on_integers(dev, m, ksub):
    g = np.random.default_rng(m)
    luts = _t(g.integers(0, 30, (6, m, ksub)).astype(np.float32), dev)
    codes = _t(g.integers(0, ksub, (500, m)).astype(np.uint8), dev)
    ids = _t(g.integers(-1, 500, (6, 100)).astype(np.int32), dev)
    assert torch.equal(ops.adc_rows(luts, codes, ids),
                       ref.adc_rows_ref(luts, codes, ids))


@pytest.mark.parametrize("L,K,V,W", [(16, 24, 30, 4), (100, 256, 166, 4),
                                     (75, 64, 128, 1)])
def test_frontier_select_bit_identical(dev, L, K, V, W):
    g = np.random.default_rng(L + K)
    B = 64
    cand_d = np.sort(g.integers(0, 6, (B, L)).astype(np.float32), 1)
    cand_i = g.permutation(B * L).reshape(B, L).astype(np.int32)
    ninv = g.integers(0, L, B)
    for b in range(B):
        cand_d[b, L - ninv[b]:] = np.inf
        cand_i[b, L - ninv[b]:] = -1
    new_i = (B * L + g.permutation(B * K)).reshape(B, K).astype(np.int32)
    new_d = g.integers(0, 6, (B, K)).astype(np.float32)
    masked = g.random((B, K)) < 0.3
    new_i[masked], new_d[masked] = -1, np.inf
    vis_i = np.full((B, V), -1, np.int32)
    vis_d = np.full((B, V), np.inf, np.float32)
    cnt = np.zeros(B, np.int32)
    for b in range(B):
        nv = int(min(g.integers(0, L - ninv[b] + 1), V))
        vis_i[b, :nv] = cand_i[b, :nv]
        vis_d[b, :nv] = cand_d[b, :nv]
        cnt[b] = nv
    args = [_t(x, dev) for x in (cand_i, cand_d, new_i, new_d, vis_i, vis_d,
                                 cnt)]
    got = ops.frontier_select(*args, W=W, max_visits=V)
    want = ref.frontier_select_batch_ref(*args, W=W, max_visits=V)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("B,C,d,R", [(16, 203, 128, 64), (8, 128, 128, 64),
                                     (4, 9, 5, 16), (6, 640, 128, 64),
                                     (2, 9000, 7, 16), (3, 300, 260, 32)])
def test_robust_prune_fp_exact_on_integers(dev, B, C, d, R):
    """The kernel gathers its rows from the table: equal to the plain
    version at the main path's two shapes, at small d, on the tiled path
    (C 640 at d 128 and C 9,000 at d 7 do not fit in shared memory; the
    rest of their rows is read from device memory every round) and at a
    d past the register-held winner (d 260)."""
    g = np.random.default_rng(C)
    N = 4 * B * C
    table = g.integers(-3, 4, (N, d)).astype(np.float32)
    anchor = g.integers(-3, 4, (B, 1, d)).astype(np.float32)
    ids = g.integers(0, N, (B, C)).astype(np.int32)
    ids[:, C // 2:C // 2 + C // 8] = ids[:, :C // 8]       # duplicates
    ids[g.random((B, C)) < 0.1] = -1
    ok = (ids >= 0) & (g.random((B, C)) > 0.2)
    ok[0] = False
    d_p = ((anchor - table[np.maximum(ids, 0)]) ** 2).sum(-1).astype(
        np.float32)
    args = [_t(x, dev) for x in (d_p, table, ids, ok)]
    go, gc = ops.robust_prune_fp(*args, alpha=1.2, R=R)
    wo, wc = ref.robust_prune_fp_ref(args[0], args[1][args[2].clamp(
        min=0).long()], *args[2:], alpha=1.2, R=R)
    assert torch.equal(go, wo) and torch.equal(gc, wc)
    assert int(gc[1:].min()) > 0


def test_train_pq_deterministic_on_card(dev):
    """The cluster sums are a one-hot contraction in a fixed order: two
    trainings on the card give equal bits."""
    from repro_torch.core import pq as pqm
    from repro_torch.core.config import PQConfig
    g = np.random.default_rng(3)
    x = _t(g.standard_normal((20000, 64)).astype(np.float32), dev)
    cfg = PQConfig(dim=64, m=16, ksub=256, kmeans_iters=6)
    assert torch.equal(pqm.train_pq(x, cfg).centroids,
                       pqm.train_pq(x, cfg).centroids)


@pytest.mark.parametrize("n", [20000, 100])
def test_train_pq_same_start_on_cpu_and_card(dev, n):
    """The initial centroids are drawn on a CPU generator: with
    kmeans_iters=0 the card returns the CPU's centroids."""
    from repro_torch.core import pq as pqm
    from repro_torch.core.config import PQConfig
    g = np.random.default_rng(4)
    x = g.standard_normal((n, 64)).astype(np.float32)
    cfg = PQConfig(dim=64, m=16, ksub=256, kmeans_iters=0, seed=5)
    assert torch.equal(pqm.train_pq(_t(x, dev), cfg).centroids.cpu(),
                       pqm.train_pq(torch.from_numpy(x), cfg).centroids)


@pytest.mark.parametrize("B,C,m,ksub,R", [(16, 203, 32, 256, 64),
                                          (8, 128, 32, 256, 64),
                                          (4, 9, 5, 200, 16)])
def test_robust_prune_sdc_exact_on_integers(dev, B, C, m, ksub, R):
    g = np.random.default_rng(C + m)
    N = 500
    codes = _t(g.integers(0, ksub, (N, m)).astype(np.uint8), dev)
    tables = _t(g.integers(0, 9, (m, ksub, ksub)).astype(np.float32), dev)
    ids_np = g.integers(0, N, (B, C)).astype(np.int32)
    ids_np[g.random((B, C)) < 0.1] = -1
    ok_np = (ids_np >= 0) & (g.random((B, C)) > 0.2)
    ok_np[0] = False
    ids, ok = _t(ids_np, dev), _t(ok_np, dev)
    d_p = _t(g.integers(0, 9 * m, (B, C)).astype(np.float32), dev)
    go, gc = ops.robust_prune_sdc(d_p, codes, tables, ids, ok, alpha=1.2,
                                  R=R)
    wo, wc = ref.robust_prune_sdc_ref(d_p, codes[ids.clamp(min=0).long()],
                                      tables, ids, ok, alpha=1.2, R=R)
    assert torch.equal(go, wo) and torch.equal(gc, wc)


def _repair_graph(g, N, R, frac_deleted):
    adj = g.integers(0, N, (N, R)).astype(np.int32)
    adj[g.random((N, R)) < 0.1] = -1
    deleted = g.random(N) < frac_deleted
    usable = ~deleted & (g.random(N) > 0.02)
    # Node 0 has every neighbour deleted: the widest candidate list.
    deleted[adj[0][adj[0] >= 0]] = True
    usable[0] = True
    return adj, deleted, usable


@pytest.mark.parametrize("R,d", [(64, 128), (8, 7)])
def test_delete_repair_fp_exact_on_integers(dev, R, d):
    g = np.random.default_rng(R + d)
    N, B = 3000, 96
    adj, deleted, usable = _repair_graph(g, N, R, 0.05)
    table = g.integers(-3, 4, (N, d)).astype(np.float32)
    node_ids = np.concatenate([[0], g.integers(0, N, B - 1)]).astype(np.int32)
    args = [_t(x, dev) for x in (adj, deleted, usable, table, node_ids)]
    got = ops.delete_repair_fp(*args, alpha=1.2, R=R)
    want = ref.delete_repair_fp_ref(*ref.repair_operands_fp(*args),
                                    alpha=1.2, R=R)
    assert torch.equal(got, want)
    assert not torch.equal(got[0], args[0][0])           # node 0 repaired


@pytest.mark.parametrize("R,m,ksub,cap", [(64, 32, 256, 8), (8, 4, 16, 3)])
def test_delete_repair_sdc_exact_on_integers(dev, R, m, ksub, cap):
    g = np.random.default_rng(R + m + cap)
    N, B = 3000, 96
    adj, deleted, usable = _repair_graph(g, N, R, 0.05)
    codes = g.integers(0, ksub, (N, m)).astype(np.uint8)
    tables = g.integers(0, 9, (m, ksub, ksub)).astype(np.float32)
    node_ids = np.concatenate([[0], g.integers(0, N, B - 1)]).astype(np.int32)
    a = [_t(x, dev) for x in (adj, deleted, usable, codes, tables, node_ids)]
    got = ops.delete_repair_sdc(*a, alpha=1.2, R=R, cap=cap)
    want = ref.delete_repair_sdc_ref(*ref.repair_operands_sdc(*a, cap),
                                     alpha=1.2, R=R)
    assert torch.equal(got, want)


@pytest.mark.parametrize("R,shape", [(64, (1024, 4)), (8, (7,)),
                                     (24, (3, 5)), (7, (2, 9))])
def test_gather_rows_bit_identical(dev, R, shape):
    """Rows equal the plain version's for int4 and 4-byte copies (R 7),
    with negative and repeated ids; use_kernel=False raises."""
    g = np.random.default_rng(R)
    table = _t(g.integers(-1, 5000, (500, R)).astype(np.int32), dev)
    ids_np = g.integers(-1, 500, shape).astype(np.int32)
    ids_np.reshape(-1)[:2] = ids_np.reshape(-1)[-1]          # repeated
    ids = _t(ids_np, dev)
    got = ops.gather_rows(table, ids)
    assert got.shape == (*shape, R)
    assert torch.equal(got, ref.gather_rows_ref(table, ids))
    with pytest.raises(ValueError, match="use_kernel=False"):
        ops.gather_rows(table, ids, use_kernel=False)


@pytest.mark.parametrize("Q,N,k", [(1024, 2560, 5), (1024, 20, 5),
                                   (7, 600, 33), (5, 3, 8), (3, 200, 128)])
def test_block_topk_bit_identical(dev, Q, N, k):
    """Integer distances with ties, +-inf and a NaN row: values and ids
    equal to the plain version's (NaN compared as NaN), k > N padded;
    use_kernel=False raises."""
    g = np.random.default_rng(Q + N + k)
    d = g.integers(0, 6, (Q, N)).astype(np.float32)
    d[g.random((Q, N)) < 0.1] = np.inf
    d[g.random((Q, N)) < 0.03] = -np.inf
    d[Q // 2, N // 2] = np.nan
    ids = _t(g.integers(0, 1 << 20, N).astype(np.int32), dev)
    dd = _t(d, dev)
    got_d, got_i = ops.block_topk(dd, ids, k)
    want_d, want_i = ref.block_topk_ref(dd, ids, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(torch.isnan(got_d), torch.isnan(want_d))
    fin = ~torch.isnan(want_d)
    assert torch.equal(got_d[fin], want_d[fin])
    with pytest.raises(ValueError, match="use_kernel=False"):
        ops.block_topk(dd, ids, k, use_kernel=False)


def test_launches_counted_and_plain_refused_on_cuda(dev):
    ops.reset_launches()
    x = torch.zeros((2, 4), device=dev)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    ops.l2_rows(x, x, ids)
    assert ops.LAUNCHES["l2_rows"] == 1
    with pytest.raises(ValueError, match="use_kernel=False"):
        ops.l2_rows(x, x, ids, use_kernel=False)
    assert ops.LAUNCHES["l2_rows"] == 1
