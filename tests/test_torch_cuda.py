"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU: it
is marked ``cuda`` and skips without one.  On a machine with the card and
the CUDA toolkit (JAX is not needed; ``--noconftest`` skips the JAX
fixtures of ``tests/conftest.py``):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Integer-valued inputs make every f32 sum exact, so kernel and plain
version must be equal; the frontier step and the row gather are compared
bit for bit on any input.  ``chip_smoke.py`` repeats these checks at the main path's shapes.

The LMs, dense and MoE (no kernel of their own), are held against the CPU
here too: each layer (the MoE FFN with capacity binding included) in f32
and bf16, one pattern group of each FULL config at full width (MoE: the
routing too), and decode against forward at full width on two pattern
groups (MoE: a forward that drops nothing).  GraphSAGE's segment mean
(forward and backward) and one full-batch and one sampled AdamW train
step are held against the CPU and run twice for equal bits.
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


@pytest.mark.parametrize("d", [1, 7, 24, 50, 100, 128, 130, 256])
def test_l2_rows_exact_on_integers(dev, d):
    """Every lane-group width (G 1 to 16) and load width (4, 8, 16
    bytes), with the tail chunk of d % 4 != 0."""
    g = np.random.default_rng(d)
    q = _t(g.integers(-4, 5, (9, d)).astype(np.float32), dev)
    table = _t(g.integers(-4, 5, (300, d)).astype(np.float32), dev)
    ids_np = g.integers(-1, 300, (9, 70)).astype(np.int32)
    ids = _t(ids_np, dev)
    assert torch.equal(ops.l2_rows(q, table, ids),
                       ref.l2_rows_ref(q, table, ids))


def _table_at(table, off_bytes):
    """A copy of ``table`` as a contiguous view ``off_bytes`` past a
    16-byte aligned allocation."""
    n, d = table.shape
    flat = torch.empty(n * d + 4, device=table.device)
    view = flat[off_bytes // 4:off_bytes // 4 + n * d].view(n, d)
    view.copy_(table)
    assert view.data_ptr() % 16 == off_bytes
    return view


@pytest.mark.parametrize("d", [50, 128, 7])
def test_l2_rows_route_independent(dev, d):
    """One pair gives the same bits whatever table it is read from and
    whatever batch it is in: Gaussian pairs read from an aligned table and
    from its copies at 4- and 8-byte offsets (4- and 8-byte loads instead
    of 16- or 8-byte ones), ids >= N among them, and with the query batch
    split in two, are ``torch.equal``."""
    g = np.random.default_rng(d + 1)
    N = 5000
    q = _t(g.standard_normal((64, d)).astype(np.float32), dev)
    table = _t(g.standard_normal((N, d)).astype(np.float32), dev)
    ids = _t(g.integers(-1, N + 2, (64, 256)).astype(np.int32), dev)
    want = ops.l2_rows(q, table, ids)
    assert torch.isinf(want[(ids < 0) | (ids >= N)]).all()
    for off in (4, 8):
        assert torch.equal(ops.l2_rows(q, _table_at(table, off), ids), want)
    split = torch.cat([ops.l2_rows(q[:23], table, ids[:23]),
                       ops.l2_rows(q[23:], table, ids[23:])])
    assert torch.equal(split, want)
    # One pair alone, and the rows fetched into a table of their own (the
    # disk lane's rerank reads them so).
    assert torch.equal(ops.l2_rows(q[5:6], table, ids[5:6, 17:18]),
                       want[5:6, 17:18])
    ok = ids[:4].clamp(0, N - 1)
    rows = table[ok.flatten().long()].contiguous()
    own = torch.arange(4 * 256, dtype=torch.int32, device=dev).view(4, 256)
    assert torch.equal(ops.l2_rows(q[:4], rows, own),
                       ops.l2_rows(q[:4], table, ok))


def test_l2_rows_d50_within_tolerance(dev):
    """SASRec's d 50 on Gaussian inputs against the plain version: rtol
    1e-5 + atol 1e-3 (two summation orders of |q|^2 + |x|^2 ~ 100)."""
    g = np.random.default_rng(50)
    q = _t(g.standard_normal((1024, 50)).astype(np.float32), dev)
    table = _t(g.standard_normal((20000, 50)).astype(np.float32), dev)
    ids = _t(g.integers(-1, 20000, (1024, 256)).astype(np.int32), dev)
    got = ops.l2_rows(q, table, ids)
    want = ref.l2_rows_ref(q, table, ids)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert bool(((got[fin] - want[fin]).abs()
                 <= 1e-5 * want[fin].abs() + 1e-3).all())


@pytest.mark.parametrize("m,ksub", [(32, 256), (8, 16), (5, 200), (25, 256)])
def test_adc_rows_exact_on_integers(dev, m, ksub):
    g = np.random.default_rng(m)
    luts = _t(g.integers(0, 30, (6, m, ksub)).astype(np.float32), dev)
    codes = _t(g.integers(0, ksub, (500, m)).astype(np.uint8), dev)
    ids = _t(g.integers(-1, 500, (6, 100)).astype(np.int32), dev)
    assert torch.equal(ops.adc_rows(luts, codes, ids),
                       ref.adc_rows_ref(luts, codes, ids))


@pytest.mark.parametrize("B,L,K,V,W,order", [
    (64, 16, 24, 30, 4, "sorted"), (64, 100, 256, 166, 4, "sorted"),
    (64, 75, 64, 128, 1, "sorted"), (1024, 100, 256, 166, 4, "sorted"),
    (1024, 100, 256, 166, 4, "unsorted"), (64, 16, 24, 30, 4, "unsorted"),
    (8, 140, 300, 200, 16, "unsorted"), (1024, 150, 256, 241, 4, "sorted"),
    (1024, 512, 256, 784, 4, "sorted")])
def test_frontier_select_bit_identical(dev, B, L, K, V, W, order):
    """Equal to the plain version bit for bit, the main path's shape B 1024
    x L 100 x K 256 x V 166 x W 4 included; "unsorted" shuffles each
    candidate list, +inf gaps and all (the kernel ranks, it does not
    merge sorted runs); (8, 140, ...) takes two rank and scan passes.  The
    filtered searches' widened shapes: L 150 (V 241) and L 512 (V 784,
    past the 256 visited ids the kernel holds in registers)."""
    g = np.random.default_rng(L + K + B)
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
    if order == "unsorted":
        perm = np.argsort(g.random((B, L)), 1)
        cand_i = np.take_along_axis(cand_i, perm, 1)
        cand_d = np.take_along_axis(cand_d, perm, 1)
    args = [_t(x, dev) for x in (cand_i, cand_d, new_i, new_d, vis_i, vis_d,
                                 cnt)]
    got = ops.frontier_select(*args, W=W, max_visits=V)
    want = ref.frontier_select_batch_ref(*args, W=W, max_visits=V)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("B,C,d,R", [(16, 203, 128, 64), (8, 128, 128, 64),
                                     (4, 9, 5, 16), (6, 640, 128, 64),
                                     (2, 9000, 7, 16), (3, 300, 260, 32),
                                     (256, 203, 50, 64)])
def test_robust_prune_fp_exact_on_integers(dev, B, C, d, R):
    """The kernel gathers its rows from the table: equal to the plain
    version at the main path's two shapes, at small d, on the tiled path
    (C 640 at d 128 and C 9,000 at d 7 do not fit in shared memory; the
    rest of their rows is read from device memory every round), at a
    d past the register-held winner (d 260) and at SASRec's d 50 (no
    float4 staging)."""
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


@pytest.mark.parametrize("B,C,m,ksub,R,neg_ok", [
    (16, 203, 32, 256, 64, False), (8, 128, 32, 256, 64, False),
    (4, 9, 5, 200, 16, False),
    (6, 300, 32, 256, 64, False),        # more columns than threads
    (16, 203, 32, 256, 64, True), (4, 300, 8, 64, 32, True)])
def test_robust_prune_sdc_exact_on_integers(dev, B, C, m, ksub, R, neg_ok):
    """Rows and counts equal to the plain version's; with ``neg_ok`` the
    mask is true on ids of -1 too (they emit -1 and read row 0's code)."""
    g = np.random.default_rng(C + m + (1 if neg_ok else 0))
    N = 500
    codes = _t(g.integers(0, ksub, (N, m)).astype(np.uint8), dev)
    tables = _t(g.integers(0, 9, (m, ksub, ksub)).astype(np.float32), dev)
    ids_np = g.integers(0, N, (B, C)).astype(np.int32)
    ids_np[g.random((B, C)) < 0.1] = -1
    ok_np = g.random((B, C)) > 0.2
    if not neg_ok:
        ok_np &= ids_np >= 0
    ok_np[0] = False
    ids, ok = _t(ids_np, dev), _t(ok_np, dev)
    d_p = _t(g.integers(0, 9 * m, (B, C)).astype(np.float32), dev)
    go, gc = ops.robust_prune_sdc(d_p, codes, tables, ids, ok, alpha=1.2,
                                  R=R)
    wo, wc = ref.robust_prune_sdc_ref(d_p, codes[ids.clamp(min=0).long()],
                                      tables, ids, ok, alpha=1.2, R=R)
    assert torch.equal(go, wo) and torch.equal(gc, wc)
    if neg_ok:
        assert bool(((go == -1) & (torch.arange(R, device=dev)[None]
                                   < gc[:, None])).any())


def _repair_graph(g, N, R, frac_deleted):
    adj = g.integers(0, N, (N, R)).astype(np.int32)
    adj[g.random((N, R)) < 0.1] = -1
    deleted = g.random(N) < frac_deleted
    usable = ~deleted & (g.random(N) > 0.02)
    # Node 0 has every neighbour deleted: the widest candidate list.
    deleted[adj[0][adj[0] >= 0]] = True
    usable[0] = True
    return adj, deleted, usable


def _repair_cases(adj, deleted, usable, g):
    """Nodes 1-3 of the fp repair fixture: node 1 with no deleted
    neighbour, node 2 not usable with a deleted one, node 3 repaired with
    no candidate left after compaction (its one deleted neighbour's row
    names only node 3)."""
    N = adj.shape[0]
    q = N - 1
    adj[3] = -1
    adj[3, 5] = q
    adj[q] = -1
    adj[q, :2] = 3
    deleted[q] = True
    deleted[1:4] = False
    usable[[1, 3]] = True
    usable[2] = False
    adj[2, 0] = q
    live = np.flatnonzero(~deleted)
    adj[1] = g.choice(live[live > 3], adj.shape[1])


@pytest.mark.parametrize("R,d", [(64, 128), (8, 7), (64, 260)])
def test_delete_repair_fp_exact_on_integers(dev, R, d):
    """Equal to the plain version on integer inputs: node 0's widest list
    (every neighbour deleted; past the resident rows at R 64, so its other
    rows are read from device memory), a node with no deleted neighbour,
    one that is not usable, one left with no candidate, and random nodes;
    d 260 takes the generic path."""
    g = np.random.default_rng(R + d)
    N, B = 3000, 96
    adj, deleted, usable = _repair_graph(g, N, R, 0.05)
    _repair_cases(adj, deleted, usable, g)
    table = g.integers(-3, 4, (N, d)).astype(np.float32)
    node_ids = np.concatenate([[0, 1, 2, 3],
                               g.integers(0, N, B - 4)]).astype(np.int32)
    args = [_t(x, dev) for x in (adj, deleted, usable, table, node_ids)]
    got = ops.delete_repair_fp(*args, alpha=1.2, R=R)
    want = ref.delete_repair_fp_ref(*ref.repair_operands_fp(*args),
                                    alpha=1.2, R=R)
    assert torch.equal(got, want)
    assert not torch.equal(got[0], args[0][0])           # node 0 repaired
    assert torch.equal(got[1:3], args[0][1:3])           # kept rows
    assert (got[3] == -1).all()                          # nothing survived


@pytest.mark.parametrize("R,m,ksub,cap", [(64, 32, 256, 8), (8, 4, 16, 3),
                                          (16, 8, 16, 4)])
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


def test_delete_repair_sdc_consecutive_block_exact(dev):
    """A block of 1,024 consecutive slots at the main path's widths (R 64,
    m 32, ksub 256, cap 8), as the global sweep launches it: nodes 0-15
    have every neighbour deleted (lists of up to C 576, past the cap), the
    rest 2 % deleted (short lists, nodes with no deleted neighbour, deleted
    and unusable nodes); equal to the plain version on integer inputs."""
    g = np.random.default_rng(1024)
    N, R, m, ksub, cap = 3000, 64, 32, 256, 8
    adj, deleted, usable = _repair_graph(g, N, R, 0.02)
    for p in range(16):
        deleted[adj[p][adj[p] >= 0]] = True
    deleted[:16] = False
    usable = ~deleted & usable
    usable[:16] = True
    codes = g.integers(0, ksub, (N, m)).astype(np.uint8)
    tables = g.integers(0, 9, (m, ksub, ksub)).astype(np.float32)
    node_ids = np.arange(1024, dtype=np.int32)
    a = [_t(x, dev) for x in (adj, deleted, usable, codes, tables, node_ids)]
    got = ops.delete_repair_sdc(*a, alpha=1.2, R=R, cap=cap)
    want = ref.delete_repair_sdc_ref(*ref.repair_operands_sdc(*a, cap),
                                     alpha=1.2, R=R)
    assert torch.equal(got, want)
    assert not torch.equal(got[:16], a[0][:16])          # wide lists repaired


@pytest.mark.parametrize("B,K,m,ksub,layout", [
    (1024, 512, 32, 256, "aligned"),     # serving's W 8
    (1, 256, 32, 256, "aligned"),        # one wave: the loop kernel
    (1000, 256, 32, 256, "aligned"),     # a partial last turn
    (2000, 100, 32, 256, "aligned"),     # several turns a block
    (256, 203, 32, 256, "aligned"),      # the insert chunks' d_p
    (3000, 100, 4, 16, "aligned"),       # m % 16 != 0: the loop kernel
    (1024, 256, 25, 256, "aligned"),     # SASRec's PQ m 25: the loop
    (3000, 100, 32, 256, "codes offset"),  # misaligned codes: the loop
    (3000, 100, 32, 256, "luts offset")])  # misaligned LUTs: the loop
def test_adc_rows_paths_exact_on_integers(dev, B, K, m, ksub, layout):
    """The persistent bulk-copy kernel (B past one wave of one block a
    query: 924 blocks at m 32, ksub 256 on an H100) and the loop kernel it
    leaves the other shapes and layouts to: equal to the plain version on
    integer inputs, ids < 0 and past the table giving +inf."""
    g = np.random.default_rng(B + K + m)
    N = 5000
    lut_np = g.integers(0, 30, (B, m, ksub)).astype(np.float32)
    codes_np = g.integers(0, ksub, (N, m)).astype(np.uint8)
    luts, codes = _t(lut_np, dev), _t(codes_np, dev)
    if layout == "codes offset":
        flat = torch.zeros(N * m + 16, dtype=torch.uint8, device=dev)
        codes = flat[3:3 + N * m].view(N, m)
        codes.copy_(_t(codes_np, dev))
    elif layout == "luts offset":
        flat = torch.zeros(B * m * ksub + 4, device=dev)
        luts = flat[1:1 + B * m * ksub].view(B, m, ksub)
        luts.copy_(_t(lut_np, dev))
    ids_np = g.integers(-1, N, (B, K)).astype(np.int32)
    ids = _t(ids_np, dev)
    got = ops.adc_rows(luts, codes, ids)
    assert torch.equal(got, ref.adc_rows_ref(luts, codes, ids))
    ids_np[0, :3] = N                                       # past the table
    got = ops.adc_rows(luts, codes, _t(ids_np, dev))
    assert torch.isinf(got[0, :3]).all()


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
                                   (7, 600, 33), (5, 3, 8), (3, 200, 128),
                                   (1024, 15, 5), (256, 2561, 5),
                                   (256, 2561, 9), (1024, 2560, 9)])
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


def test_block_topk_signed_zeros_and_unaligned_rows(dev):
    """-0.0 and +0.0 are equal (the lowest column first, each pick's own
    bits kept); N 2560 from a 4-byte offset takes the single-value loads:
    both bit-identical to the plain version."""
    g = np.random.default_rng(5)
    Q, N, k = 64, 2560, 8
    d = g.integers(0, 3, (Q, N)).astype(np.float32)
    d[(d == 0) & (g.random((Q, N)) < 0.5)] = -0.0
    ids = _t(g.integers(0, 1 << 20, N).astype(np.int32), dev)
    buf = torch.empty(Q * N + 1, device=dev)
    off = buf[1:].view(Q, N)
    off.copy_(_t(d, dev))
    for x in (_t(d, dev), off):
        got_d, got_i = ops.block_topk(x, ids, k)
        want_d, want_i = ref.block_topk_ref(x, ids, k)
        assert torch.equal(got_i, want_i)
        assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    assert bool(torch.signbit(want_d).any() and (want_d == 0).all())


def test_launches_counted_and_plain_refused_on_cuda(dev):
    ops.reset_launches()
    x = torch.zeros((2, 4), device=dev)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    ops.l2_rows(x, x, ids)
    assert ops.LAUNCHES["l2_rows"] == 1
    with pytest.raises(ValueError, match="use_kernel=False"):
        ops.l2_rows(x, x, ids, use_kernel=False)
    assert ops.LAUNCHES["l2_rows"] == 1


def test_filtered_system_equal_on_cpu_and_card(dev):
    """A small labelled system from integer data and an integer codebook:
    filtered searches (labels, tenants, both, and after a merge and a
    consolidate) on the card, through the kernels, equal the CPU's plain
    path bit for bit."""
    from repro_torch.core import pq as pqm
    from repro_torch.core.config import IndexConfig, PQConfig, SystemConfig
    from repro_torch.core.graph import FilterSpec
    from repro_torch.core.system import bootstrap_system
    g = np.random.default_rng(7)
    d, n0 = 16, 256
    base = g.integers(-3, 4, (n0, d)).astype(np.float32)
    new = g.integers(-3, 4, (160, d)).astype(np.float32)
    qs = g.integers(-3, 4, (37, d)).astype(np.float32)
    cent = g.integers(-3, 4, (4, 16, 4)).astype(np.float32)
    cfg = SystemConfig(
        index=IndexConfig(capacity=512, dim=d, R=8, L_build=16, L_search=24,
                          alpha=1.2, beam_width=4),
        pq=PQConfig(dim=d, m=4, ksub=16), ro_snapshot_points=32,
        merge_threshold=96, temp_capacity=96, insert_batch=16,
        batch_queries=16, merge_block=64, filter_words=1)
    specs = [FilterSpec(all_of=(1,)), FilterSpec(tenant=2),
             FilterSpec(all_of=(0,), any_of=(2, 3), tenant=1)]
    out = {}
    for where in ("cpu", "cuda"):
        s = bootstrap_system(base, np.arange(n0), cfg, device=where,
                             batch=32, labels=[[i % 4] for i in range(n0)],
                             tenants=[i % 3 for i in range(n0)],
                             codebook=pqm.PQCodebook(torch.from_numpy(cent)))
        res = []
        for i in range(len(new)):
            s.insert(1000 + i, new[i], labels=[i % 4, 1], tenant=i % 3)
            if i == 70:
                res += [x for sp in specs for x in s.search_batch(
                    qs, 12, L=48, filter=sp)]
        for e in (3, 17, 1005, 1050):
            s.delete(e)
        s.consolidate(mode="global")
        res += [x for sp in specs for x in s.search_batch(
            qs, 12, L=48, filter=sp)]
        res += [s.lti_labels.bits, s.lti_labels.tenant, s.lti_ext_ids]
        assert s.stats.merges >= 1
        out[where] = res
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(a, b)


def _recsys_pair(name, dev):
    """A smoke-size model on the CPU and its copy on the card."""
    import copy
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys as rec
    cfg = get_arch(name).smoke_config
    cpu = rec.init_recsys_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    return cfg, cpu, copy.deepcopy(cpu).to(dev)


@pytest.mark.parametrize("name", ["fm", "deepfm", "xdeepfm", "sasrec"])
def test_recsys_forward_card_equals_cpu(dev, name):
    """Each model's forward on the card against the same weights on the
    CPU: rtol 1e-4, atol 1e-6 (f32 sums in another order; TF32 off), and
    ``retrieval_topk`` on an integer table (exact scores, many ties): the
    CPU's ids in the CPU's order."""
    from repro_torch.core.config import resolve_device
    from repro_torch.models import recsys as rec
    resolve_device(dev)                              # TF32 off
    cfg, cpu, card = _recsys_pair(name, dev)
    g = np.random.default_rng(3)
    with torch.no_grad():
        if name == "sasrec":
            x = g.integers(1, cfg.n_items, (64, cfg.seq_len)).astype(np.int32)
            x[0, :5] = 0
            x[1] = 0
            fn = rec.sasrec_encode
        else:
            x = (g.integers(0, cfg.rows_per_field, (64, cfg.n_sparse))
                 + np.arange(cfg.n_sparse) * cfg.rows_per_field).astype(
                np.int32)
            fn = rec.recsys_forward
        want = fn(cpu, torch.from_numpy(x), cfg)
        got = fn(card, _t(x, dev), cfg).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    q = g.integers(-2, 3, (5, cfg.embed_dim)).astype(np.float32)
    table = g.integers(-1, 2, (4096, cfg.embed_dim)).astype(np.float32)
    for C in (4096, 4000):                   # two-stage and direct
        ws, wi = rec.retrieval_topk(torch.from_numpy(q),
                                    torch.from_numpy(table[:C]), 50)
        gs, gi = rec.retrieval_topk(_t(q, dev), _t(table[:C], dev), 50)
        assert torch.equal(gi.cpu(), wi) and torch.equal(gs.cpu(), ws)


def test_embedding_bag_same_bits_twice_on_card(dev):
    """The bags are summed in a fixed order (no atomics): two runs on the
    card give equal bits, close to the CPU's.  Bag 17 is hot (100,000
    ids): its f32 sum of terms of ~1 may be added in another order than
    the CPU's, so it is held to atol 1e-2 (sum) and the rest to 1e-5."""
    from repro_torch.models import recsys as rec
    g = np.random.default_rng(4)
    table = g.standard_normal((100_000, 16)).astype(np.float32)
    ids = g.integers(0, 100_000, 500_000).astype(np.int32)
    seg = g.integers(0, 4096, 500_000).astype(np.int32)
    seg[g.permutation(500_000)[:100_000]] = 17
    args = (_t(table, dev), _t(ids, dev), _t(seg, dev), 4097)
    for mode in ("sum", "mean"):
        a = rec.embedding_bag(*args, mode=mode)
        b = rec.embedding_bag(*args, mode=mode)
        assert torch.equal(a, b)
        want = rec.embedding_bag(torch.from_numpy(table),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(seg), 4097, mode=mode)
        rest = torch.arange(4097) != 17
        torch.testing.assert_close(a.cpu()[rest], want[rest], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(a.cpu()[17], want[17], rtol=1e-5,
                                   atol=1e-2 if mode == "sum" else 1e-7)
        assert not a[4096].any()                     # the empty bag


# ---------------------------------------------------------------------------
# The dense LMs: layers, one pattern group and decode against forward
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lm_layer(name, dtype, device):
    """(function, args) of one LM layer at small widths, drawn on the CPU
    and moved to ``device``."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(5)

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dtype).to(device)

    if name == "rms_norm":
        return L.rms_norm, (r(4, 33, 256, s=3.0), r(256, s=0.1).float())
    if name == "rope":
        pos = torch.cat([torch.arange(64), torch.arange(524_224, 524_288)])
        return (lambda x, p: L.rope(x, p, 1e6)), (r(2, 128, 4, 256),
                                                  pos[None].to(device))
    if name == "swiglu":
        return L.swiglu, (r(3, 40, 256), r(256, 512, s=0.06),
                          r(256, 512, s=0.06), r(512, 256, s=0.04))
    if name == "chunked_attention":
        return (lambda q, k, v: L.chunked_attention(
            q, k, v, window=200, q_chunk=64, kv_chunk=128)), (
            r(2, 512, 8, 64), r(2, 512, 2, 64), r(2, 512, 2, 64))
    if name == "moe_ffn":
        from repro_torch.models import moe
        cfg = moe.MoEConfig(n_experts=16, top_k=4, d_model=256, d_ff=128,
                            capacity_factor=1.0, n_groups=4)
        return (lambda x, *w: moe.moe_ffn(dict(zip(
            ("router", "w_gate", "w_up", "w_down"), w)), x, cfg)[0]), (
            r(3, 40, 256), r(256, 16, s=0.06).float(), r(16, 256, 128, s=0.06),
            r(16, 256, 128, s=0.06), r(16, 128, 256, s=0.09))
    pos = torch.arange(300, dtype=torch.int32)
    pos[250:] = -1
    return (lambda q, k, v, c: L.decode_attention(q, k, v, c, 249,
                                                  window=100)), (
        r(3, 1, 8, 64), r(3, 300, 2, 64), r(3, 300, 2, 64), pos.to(device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["rms_norm", "rope", "swiglu",
                                  "chunked_attention", "decode_attention",
                                  "moe_ffn"])
def test_lm_layer_card_equals_cpu(dev, name, dtype):
    """Each LM layer on the card against the CPU on the same inputs: f32
    rtol 1e-4, atol 1e-6 (rope at positions up to 524,287 included; TF32
    off); bf16 rtol 1e-2, atol 1e-2 (one bf16 rounding apart at most)."""
    from repro_torch.core.config import resolve_device
    resolve_device(dev)
    dt = getattr(torch, dtype)
    fn, args = _lm_layer(name, dt, "cpu")
    _, card_args = _lm_layer(name, dt, dev)
    got = fn(*card_args)
    assert got.dtype == dt
    tol = (dict(rtol=1e-4, atol=1e-6) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-2))
    torch.testing.assert_close(got.cpu().float(), fn(*args).float(), **tol)


def test_mm_f32_on_card(dev):
    """bf16 operands: ``torch.bmm(out_dtype=float32)`` on a strided cache
    view equals the f32 product of the upcast operands (every bf16 product
    is exact in f32; only the order of the f32 sums differs)."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(4, 6, 128, generator=g, device=dev).bfloat16()
    cache = torch.randn(4, 1000, 8, 128, generator=g, device=dev).bfloat16()
    b = cache[:, :, 3].transpose(1, 2)
    got = L.mm_f32(a, b)
    assert got.dtype == torch.float32
    want = torch.bmm(a.float(), b.float())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_argmax_takes_first_maximum_on_card(dev):
    _chip_smoke()._argmax_ties(dev)


LM_NAMES = ["qwen3-14b", "qwen2-1.5b", "gemma3-12b", "mixtral-8x7b",
            "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("name", LM_NAMES)
def test_lm_one_group_full_width_card_equals_cpu(dev, name):
    """One pattern group of the FULL config in f32, weights drawn on the
    card and copied to the CPU: prefill logits and caches (MoE: expert
    choices and drop masks), then 2 greedy steps, held to
    ``chip_smoke._tolerance`` (gemma3 at S 1,280, past its window)."""
    import dataclasses
    from repro_torch.configs import get_arch
    cs = _chip_smoke()
    full = get_arch(name).full_config
    cfg = dataclasses.replace(full, n_layers=len(full.pattern),
                              dtype="float32")
    S = 1280 if 0 < full.window < 1280 else 256
    cs.lm_card_vs_cpu(name, cfg, S, 2, 0, dev)


@pytest.mark.parametrize("name", LM_NAMES)
def test_lm_decode_matches_forward_on_card(dev, name):
    """Decode against forward on the card at full width, two pattern
    groups in f32 (B 1, S 128, 128 steps from ``init_cache``), to
    ``chip_smoke._tolerance``; an MoE forward at a capacity factor that
    drops nothing, as decoding never drops."""
    import dataclasses
    from repro_torch.configs import get_arch
    full = get_arch(name).full_config
    cfg = dataclasses.replace(full, n_layers=2 * len(full.pattern),
                              dtype="float32")
    _chip_smoke().lm_decode_vs_forward(name, cfg, 128, 0, dev)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "gemma3-12b",
                                  "mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_lm_loss_grads_card_equals_cpu(dev, name):
    """``lm_loss`` and its gradients through the flash backward at S 64
    in kv blocks of 16 (gemma3 with its window of 8; the MoE archs
    through the dispatch, their routing equal first) on the card against
    the CPU, to ``chip_smoke._tolerance``."""
    _chip_smoke().lm_grads_card_vs_cpu(name, dev)


def _sage_graph_pair(dev, n=3000, e=40_000, seed=5):
    from repro_torch.models import gnn
    g = np.random.default_rng(seed)
    src = g.integers(0, n, e)
    dst = (src + g.zipf(1.5, e)) % n
    cpu = gnn.SageGraph(torch.from_numpy(src), torch.from_numpy(dst), n)
    card = gnn.SageGraph(_t(src, dev), _t(dst, dev), n)
    return cpu, card


@pytest.mark.parametrize("max_edges", [None, 5000, 1])
def test_segment_mean_card_equals_cpu_and_repeats(dev, max_edges):
    """``SegmentMean`` forward and backward on the card: equal to the
    CPU's (each segment summed in edge order on both), and two runs give
    equal bits."""
    from repro_torch.models import gnn
    cpu_g, card_g = _sage_graph_pair(dev)
    g = np.random.default_rng(6)
    h = g.standard_normal((3000, 64)).astype(np.float32)
    gy = g.standard_normal((3000, 64)).astype(np.float32)

    def run(graph, x, y):
        x = x.clone().requires_grad_()
        out = gnn.segment_mean(x, graph, True, max_edges)
        out.backward(y)
        return out.detach().cpu(), x.grad.cpu()

    want = run(cpu_g, torch.from_numpy(h), torch.from_numpy(gy))
    a = run(card_g, _t(h, dev), _t(gy, dev))
    b = run(card_g, _t(h, dev), _t(gy, dev))
    for x, y, w in zip(a, b, want):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("form", ["full", "sampled"])
def test_sage_train_step_card_equals_cpu(dev, form):
    """One AdamW train step of the full-batch and the sampled GraphSAGE
    on the card: its loss and gradients against the same step's on the
    CPU (rtol 1e-4, atol 1e-6 x the leaf's largest |g|: f64 products, f32
    sums in edge order), and the step run twice on the card gives equal
    bits.  Parameters after the step are not compared: AdamW's first
    step moves each by about sign(g) * lr, so a gradient element near 0
    that differs by a rounding moves its parameter visibly."""
    from repro_torch.configs import get_arch
    from repro_torch.core.config import resolve_device
    from repro_torch.data.pipelines import synthetic_graph
    from repro_torch.models import gnn
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.training.steps import loss_and_grads, make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    resolve_device(dev)                              # TF32 off
    cfg = get_arch("graphsage-reddit").smoke_config
    gr = synthetic_graph(600, 6, cfg.d_feat, cfg.n_classes, seed=2)
    params = gnn.init_sage_params(cfg, torch.Generator().manual_seed(1),
                                  "cpu")
    out = {}
    for where in ("cpu", "card"):
        d = torch.device("cpu") if where == "cpu" else dev
        t = {k: torch.from_numpy(v).to(d) for k, v in gr.items()}
        if form == "full":
            graph = gnn.SageGraph(t["src"], t["dst"], 600)
            mask = torch.arange(600, device=d) % 3 == 0

            def loss_fn(p, b, t=t, graph=graph, mask=mask):
                loss = gnn.sage_loss_full(p, t["feats"], graph, t["labels"],
                                          mask, cfg)
                return loss, {}
        else:
            seeds = torch.arange(0, 600, 7, device=d)

            def loss_fn(p, b, t=t, seeds=seeds):
                loss = gnn.sage_loss_sampled(p, 3, t["feats"], t["offsets"],
                                             t["nbrs"], seeds,
                                             t["labels"][seeds], cfg)
                return loss, {}
        p = tree_map(lambda x: x.to(d), params)
        loss, _, grads = loss_and_grads(loss_fn, p, {})
        step = make_train_step(loss_fn, lr=3e-3)
        out[where] = (loss, grads,
                      [step(p, adamw_init(p), {}) for _ in range(2)])
    (pa, oa, _), (pb, ob, _) = out["card"][2]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves((pa, oa)),
                                                 tree_leaves((pb, ob))))
    torch.testing.assert_close(out["card"][0].cpu(), out["cpu"][0],
                               rtol=1e-4, atol=1e-6)
    for x, y in zip(out["card"][1], out["cpu"][1]):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4,
                                   atol=1e-6 * float(y.abs().max()))
