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


@pytest.mark.parametrize("d", [128, 24, 7, 50])
def test_l2_rows_exact_on_integers(dev, d):
    g = np.random.default_rng(d)
    q = _t(g.integers(-4, 5, (9, d)).astype(np.float32), dev)
    table = _t(g.integers(-4, 5, (300, d)).astype(np.float32), dev)
    ids_np = g.integers(-1, 300, (9, 70)).astype(np.int32)
    ids = _t(ids_np, dev)
    assert torch.equal(ops.l2_rows(q, table, ids),
                       ref.l2_rows_ref(q, table, ids))


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
