"""The port's kernel contracts against the JAX package's kernels.

For each kernel the JAX kernel runs through ``repro.kernels.ops`` with
``use_kernel=True`` (Pallas in interpret mode on the CPU, as
``tests/test_kernels.py`` runs it) and the port's wrapper runs on CPU
tensors, which takes its plain PyTorch version.  The CUDA kernels
themselves are held against the same plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).

Tolerances: integer-valued fixtures must match exactly (every f32 sum is
exact in any order).  Gaussian fixtures: rtol 1e-5; the L2 norm identity
``|q|^2 - 2 q.x + |x|^2`` also gets atol 1e-4 * (|q|^2 + |x|^2) for the
cancellation that two reduction orders round differently.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

KINDS = ["integer", "gaussian"]


def _vals(g, kind, shape, lo=-4, hi=5):
    if kind == "integer":
        return g.integers(lo, hi, shape).astype(np.float32)
    return g.standard_normal(shape).astype(np.float32)


def _ids(g, B, K, N, frac_invalid=0.15):
    ids = g.integers(0, N, (B, K)).astype(np.int32)
    ids[g.random((B, K)) < frac_invalid] = -1
    return ids


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,K,N,d", [(5, 37, 200, 24), (3, 128, 64, 32),
                                     (1, 1, 9, 8)])
def test_l2_rows_matches_jax_kernel(kind, B, K, N, d):
    g = np.random.default_rng(B * 1000 + K)
    q = _vals(g, kind, (B, d))
    table = _vals(g, kind, (N, d))
    ids = _ids(g, B, K, N)
    ids[0, 0] = -1                                        # a masked lane
    full = np.asarray(jops.l2_distances(jnp.asarray(q), jnp.asarray(table),
                                        use_kernel=True))
    want = np.where(ids >= 0, np.take_along_axis(
        full, np.maximum(ids, 0), axis=1), np.inf).astype(np.float32)
    got = ops.l2_rows(torch.from_numpy(q), torch.from_numpy(table),
                      torch.from_numpy(ids)).numpy()
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        scale = ((q * q).sum(1)[:, None]
                 + (table * table).sum(1)[np.maximum(ids, 0)])
        fin = np.isfinite(want)
        assert (np.isfinite(got) == fin).all()
        assert (np.abs(got[fin] - want[fin])
                <= 1e-5 * np.abs(want[fin]) + 1e-4 * scale[fin]).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,K,N,m,ksub", [(4, 40, 300, 8, 16),
                                          (2, 129, 50, 16, 256)])
def test_adc_rows_matches_jax_kernel(kind, B, K, N, m, ksub):
    g = np.random.default_rng(K)
    codes = g.integers(0, ksub, (N, m)).astype(np.uint8)
    luts = (g.integers(0, 20, (B, m, ksub)).astype(np.float32)
            if kind == "integer"
            else (g.standard_normal((B, m, ksub)) ** 2).astype(np.float32))
    ids = _ids(g, B, K, N)
    full = np.asarray(jops.adc_distances(jnp.asarray(codes),
                                         jnp.asarray(luts), use_kernel=True))
    want = np.where(ids >= 0, np.take_along_axis(
        full, np.maximum(ids, 0), axis=1), np.inf).astype(np.float32)
    got = ops.adc_rows(torch.from_numpy(luts), torch.from_numpy(codes),
                       torch.from_numpy(ids)).numpy()
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _frontier_rows(seed, B, L, K, V, kind, nvis_frac=0.5):
    """Engine-consistent rows: a sorted candidate list with an INVALID tail,
    fresh neighbours with masked lanes, a visited subset of the list."""
    g = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        ncand = int(g.integers(1, L + 1))
        nnew = int(g.integers(0, K + 1))
        pool = g.permutation(10_000)[:ncand + nnew].astype(np.int32)
        draw = ((lambda n: g.integers(0, 5, n).astype(np.float32))
                if kind == "integer"
                else (lambda n: g.random(n).astype(np.float32)))
        ci = np.full(L, -1, np.int32)
        cd = np.full(L, np.inf, np.float32)
        ci[:ncand] = pool[:ncand]
        cd[:ncand] = np.sort(draw(ncand))
        ni = np.full(K, -1, np.int32)
        nd = np.full(K, np.inf, np.float32)
        ni[:nnew] = pool[ncand:]
        nd[:nnew] = draw(nnew)
        vi = np.full(V, -1, np.int32)
        vd = np.full(V, np.inf, np.float32)
        nvis = min(int(ncand * nvis_frac), V - 1)
        taken = g.permutation(ncand)[:nvis]
        vi[:nvis] = ci[taken]
        vd[:nvis] = cd[taken]
        out.append((ci, cd, ni, nd, vi, vd, np.int32(nvis)))
    return [np.stack(col) for col in zip(*out)]


def _frontier_both(args, W, max_visits):
    want = jops.frontier_select_batch(*[jnp.asarray(a) for a in args], W=W,
                                      max_visits=max_visits,
                                      use_kernel=True)
    got = ops.frontier_select(*[torch.from_numpy(np.ascontiguousarray(a))
                                for a in args], W=W, max_visits=max_visits)
    return want, got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("W", [1, 4, 16])
def test_frontier_select_matches_jax_kernel(kind, W):
    """Bit-identical merged list, frontier and visited arrays (the kernel
    does no arithmetic); integer distances make ties everywhere."""
    L, K, V = 16, 24, 30
    args = _frontier_rows(W, 6, L, K, V, kind)
    want, got = _frontier_both(args, W, V)
    for w, gt, name in zip(want, got, ["m_ids", "m_d", "f_ids", "f_d",
                                       "vis_ids", "vis_d", "vis_cnt"]):
        np.testing.assert_array_equal(np.asarray(w), gt.numpy(),
                                      err_msg=name)


def test_frontier_select_few_open_and_full_visited():
    """W larger than the open entries left, and a visited set already at
    its budget (the loop's stop condition: an empty frontier)."""
    L, K, V, W = 8, 8, 6, 4
    args = _frontier_rows(7, 3, L, K, V, "integer", nvis_frac=0.0)
    # Row 0: a single open entry (W=4 > 1 open).
    args[0][0] = -1
    args[0][0, 0] = 77
    args[1][0] = np.inf
    args[1][0, 0] = 1.0
    args[2][0] = -1
    args[3][0] = np.inf
    # Row 1: visited set full (occupancy == max_visits).
    args[4][1] = np.arange(20_000, 20_000 + V, dtype=np.int32)
    args[5][1] = 0.0
    args[6][1] = V
    want, got = _frontier_both(args, W, V)
    for w, gt in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), gt.numpy())
    f_ids = got[2].numpy()
    assert list(f_ids[0]) == [77, -1, -1, -1]
    assert (f_ids[1] == -1).all() and int(got[6][1]) == V


def _prune_rows(seed, B, C, d, kind, N=None):
    """(d_p, table, ids, ok): candidate ids into a table [N, d], with
    duplicates within each row, ids < 0 and masked lanes, and an all-masked
    row 0; the anchor distances are exact ones to a random anchor."""
    g = np.random.default_rng(seed)
    N = N or 2 * B * C
    table = _vals(g, kind, (N, d), -3, 4)
    anchor = _vals(g, kind, (B, 1, d), -3, 4)
    ids = g.permutation(N)[:B * C].reshape(B, C).astype(np.int32)
    ids[:, C // 2:] = ids[:, :C - C // 2]                 # duplicates
    ids[g.random((B, C)) < 0.1] = -1
    ok = (ids >= 0) & (g.random((B, C)) > 0.2)
    ok[0] = False                                          # all-inf row
    d_p = ((anchor - table[np.maximum(ids, 0)]) ** 2).sum(-1).astype(
        np.float32)
    return d_p, table, ids, ok


def _jax_prune(d_p, table, ids, ok, alpha, R):
    """The reference's Pallas kernel on the gathered rows (ids < 0 read
    row 0, as the port's wrapper does; those lanes are masked)."""
    vecs = table[np.maximum(ids, 0)]
    w_ids, w_cnt = jops.robust_prune_fp(
        *[jnp.asarray(a) for a in (d_p, vecs, ids, ok)], alpha=alpha, R=R,
        use_kernel=True)
    return np.asarray(w_ids), np.asarray(w_cnt)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("B,C,d,R", [(3, 40, 16, 8), (2, 67, 24, 12),
                                     (4, 7, 8, 16)])
def test_robust_prune_fp_matches_jax_kernel(kind, alpha, B, C, d, R):
    """The wrapper takes the table and the ids (the kernel gathers the
    rows); on CPU tensors its plain version equals the Pallas kernel."""
    args = _prune_rows(C + R, B, C, d, kind)
    w_ids, w_cnt = _jax_prune(*args, alpha, R)
    g_ids, g_cnt = ops.robust_prune_fp(*[torch.from_numpy(a) for a in args],
                                       alpha=alpha, R=R)
    np.testing.assert_array_equal(w_ids, g_ids.numpy())
    np.testing.assert_array_equal(w_cnt, g_cnt.numpy())
    assert (g_ids.numpy()[0] == -1).all() and int(g_cnt[0]) == 0


def _emulate_prune_fp(d_p, table, ids, ok, *, alpha, R, n_res):
    """The robust_prune_fp kernel's walk, one block per row, in torch: the
    first ``n_res`` alive candidates' rows are staged once (rows never
    staged read as NaN, so a stray read shows), the rest are read from the
    table in every round; 8-lane groups own the columns c = grp + 32 i for
    the whole kernel and keep their least surviving (key, column) while
    they retire what the winner covers, and the block's least of those is
    the next round's winner."""
    groups = 32
    B, C = ids.shape
    out = torch.full((B, R), -1, dtype=torch.int32)
    cnt = torch.zeros(B, dtype=torch.int32)
    inf = float("inf")
    for b in range(B):
        key = [float(v) if bool(o) and np.isfinite(float(v)) else inf
               for v, o in zip(d_p[b], ok[b])]
        sid = [int(i) for i in ids[b]]
        rows = table[ids[b].clamp(min=0).long()].clone()
        for c in range(min(n_res, C)):
            if key[c] == inf:
                rows[c] = float("nan")            # never staged
        best = min((key[c], c) for c in range(C)) if C else (inf, C)
        for r in range(R):
            if not best[0] < inf:
                break
            star = best[1]
            out[b, r] = sid[star]
            cnt[b] += 1
            cover = ((rows[star][None] - rows) ** 2).sum(-1)
            survivors = []
            for g in range(groups):
                mine = (inf, C)
                for c in range(g, C, groups):
                    if key[c] == inf:
                        continue
                    if c == star or alpha * float(cover[c]) <= key[c]:
                        key[c] = inf
                    else:
                        mine = min(mine, (key[c], c))
                survivors.append(mine)
            best = min(survivors)
    return out, cnt


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,C,d,R,n_res,alpha", [
    (3, 70, 16, 12, 70, 1.2),       # every row resident
    (3, 70, 16, 6, 23, 1.2),        # tiled: 23 resident, 47 read each round
    (2, 45, 7, 16, 0, 1.2),         # nothing resident; d not a multiple of 4
    (2, 100, 36, 40, 64, 1.2),      # more rounds than survivors
    (3, 60, 4, 30, 60, 1.0)])       # d 4, alpha 1
def test_robust_prune_fp_kernel_walk_matches_contract(kind, B, C, d, R,
                                                      n_res, alpha):
    """The kernel's resident and tiled candidate split, its group-owned
    columns and the argmin folded into the cover pass (emulated in torch)
    give the contract's rows: equal on integer inputs, and on Gaussian ones
    too at these sizes (no cover test falls within the two sum orders'
    rounding); at R 6 the rounds run out before the candidates do."""
    args = [torch.from_numpy(a) for a in _prune_rows(C * d, B, C, d, kind)]
    want = ref.robust_prune_fp_ref(args[0], args[1][args[2].clamp(
        min=0).long()], args[2], args[3], alpha=alpha, R=R)
    got = _emulate_prune_fp(*args, alpha=alpha, R=R, n_res=n_res)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1][1:].min()) > 0
    if R == 6:
        assert int(want[1].max()) == R


def _topk_jax(d, ids, k):
    gd, gi = jops.block_topk(jnp.asarray(d), jnp.asarray(ids), k)
    return np.asarray(gd), np.asarray(gi)


def _topk_port(d, ids, k):
    gd, gi = ops.block_topk(torch.from_numpy(d), torch.from_numpy(ids), k)
    return gd.numpy(), gi.numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("q,n,k", [(1, 300, 10), (7, 300, 10), (8, 512, 1),
                                   (3, 1024, 64), (9, 77, 5)])
def test_block_topk_matches_jax_kernel(kind, q, n, k):
    """The shapes of ``tests/test_kernels.py``; integer distances put ties
    everywhere (the lowest column first), Gaussian ones none."""
    g = np.random.default_rng(q * 100 + n + k)
    d = (g.integers(0, 8, (q, n)) if kind == "integer"
         else g.standard_normal((q, n))).astype(np.float32)
    ids = g.permutation(1 << 16)[:n].astype(np.int32)
    want = _topk_jax(d, ids, k)
    got = _topk_port(d, ids, k)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("case", ["inf_padding", "plus_minus_inf", "nan_row",
                                  "k_over_n"])
def test_block_topk_edge_rules_match_jax_kernel(case):
    """The Pallas kernel's rules, which its ``ref.block_topk_ref`` does not
    share: a non-finite pick reports id -1 (``test_topk_with_inf_padding``'s
    row, and -inf), a row holding a NaN gives (NaN, -1) throughout, and
    k > N pads with (+inf, -1)."""
    g = np.random.default_rng(7)
    k = 4
    if case == "inf_padding":
        d = np.array([[1.0, np.inf, 0.5, np.inf, 2.0]], np.float32)
        ids = np.array([10, 11, 12, 13, 14], np.int32)
    else:
        d = g.integers(0, 5, (6, 700)).astype(np.float32)
        ids = g.integers(0, 1 << 20, 700).astype(np.int32)
        d[g.random(d.shape) < 0.2] = np.inf
        if case == "plus_minus_inf":
            d[g.random(d.shape) < 0.01] = -np.inf
        elif case == "nan_row":
            d[2, 600] = np.nan                    # in the second block
            d[4, 3] = np.nan
        else:
            d, ids, k = d[:, :3], ids[:3], 9
    want = _topk_jax(d, ids, k)
    got = _topk_port(d, ids, k)
    np.testing.assert_array_equal(got[0], want[0])    # NaN == NaN here
    np.testing.assert_array_equal(got[1], want[1])
    if case == "inf_padding":
        assert got[1][0].tolist() == [12, 10, 14, -1]
    elif case == "nan_row":
        assert np.isnan(got[0][[2, 4]]).all() and (got[1][[2, 4]] == -1).all()
    elif case == "k_over_n":
        assert np.isinf(got[0][:, 3:]).all() and (got[1][:, 3:] == -1).all()


def test_block_topk_rejects_k_out_of_range():
    d = torch.zeros((2, 300))
    ids = torch.arange(300, dtype=torch.int32)
    for k in (0, 129):
        with pytest.raises(ValueError, match="outside"):
            ops.block_topk(d, ids, k)
    with pytest.raises(ValueError):
        ops.block_topk(d, ids[:10], 3)


def test_cpu_tensors_never_launch():
    """Every wrapper takes its plain version for CPU tensors: no launch is
    counted and nothing is built."""
    ops.reset_launches()
    q = torch.zeros((2, 8))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    ops.l2_rows(q, q, ids)
    ops.adc_rows(torch.zeros((2, 4, 16)), torch.zeros((2, 4),
                                                      dtype=torch.uint8), ids)
    args = _frontier_rows(0, 2, 4, 4, 6, "integer")
    ops.frontier_select(*[torch.from_numpy(np.ascontiguousarray(a))
                          for a in args], W=2)
    ops.robust_prune_fp(*[torch.from_numpy(a)
                          for a in _prune_rows(0, 2, 5, 4, "integer")],
                        alpha=1.2, R=3)
    ops.block_topk(torch.zeros((2, 6)), torch.arange(6, dtype=torch.int32),
                   3)
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def test_wrappers_reject_bad_operands():
    q = torch.zeros((2, 8))
    with pytest.raises(TypeError):
        ops.l2_rows(q, q, torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.l2_rows(q, torch.zeros((4, 7)),
                    torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        args = _frontier_rows(0, 2, 4, 4, 6, "integer")
        ops.frontier_select(*[torch.from_numpy(np.ascontiguousarray(a))
                              for a in args], W=5)       # W > L


def test_plain_refs_match_contract_forms():
    """l2_rows_ref / adc_rows_ref are the gather-fused forms of the
    reference contracts l2_distances_ref / adc_distances_ref."""
    g = np.random.default_rng(3)
    q = torch.from_numpy(_vals(g, "integer", (3, 12)))
    table = torch.from_numpy(_vals(g, "integer", (30, 12)))
    ids = torch.from_numpy(_ids(g, 3, 10, 30))
    dense = ref.l2_distances_ref(q, table)
    want = torch.where(ids >= 0, dense.gather(1, ids.clamp(min=0).long()),
                       torch.tensor(float("inf")))
    assert torch.equal(ref.l2_rows_ref(q, table, ids), want)
    codes = torch.from_numpy(g.integers(0, 16, (30, 4)).astype(np.uint8))
    luts = torch.from_numpy(g.integers(0, 9, (3, 4, 16)).astype(np.float32))
    got = ref.adc_rows_ref(luts, codes, ids)
    for b in range(3):
        row = ref.adc_distances_ref(codes, luts[b])
        want = torch.where(ids[b] >= 0, row[ids[b].clamp(min=0).long()],
                           torch.tensor(float("inf")))
        assert torch.equal(got[b], want)


def test_single_row_forms_match_batched():
    """frontier_select_ref is the batch contract for one row, and
    distance.gather_l2 the plain engine's one-query gather."""
    from repro_torch.core.distance import gather_l2, l2_sq
    args = _frontier_rows(5, 3, 8, 8, 12, "integer")
    batch = ref.frontier_select_batch_ref(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args], W=3)
    for b in range(3):
        one = ref.frontier_select_ref(
            *[torch.from_numpy(np.ascontiguousarray(a[b])) for a in args],
            W=3)
        for x, y in zip(one, batch):
            assert torch.equal(x, y[b])
    g = np.random.default_rng(1)
    vecs = torch.from_numpy(_vals(g, "integer", (20, 6)))
    ids = torch.tensor([3, -1, 19, 0], dtype=torch.int32)
    got = gather_l2(vecs[7], vecs, ids)
    want = l2_sq(vecs[7][None], vecs[ids.clamp(min=0).long()])
    assert torch.equal(got[[0, 2, 3]], want[[0, 2, 3]])
    assert got[1] == float("inf")


def test_launch_resolves_each_kernel_once(monkeypatch):
    """``_launch`` binds a kernel's C entry point on its first launch and
    then takes it from ``ops._FNS``; a nonzero return code still raises and
    is not counted."""
    calls = []
    codes = {"l2_rows": 0, "adc_rows": 719}

    def resolve(name):
        calls.append(name)
        return lambda *args: codes[name]

    monkeypatch.setattr(ops, "_FNS", {})
    monkeypatch.setattr(ops, "_resolve", resolve)
    monkeypatch.setattr(ops, "LAUNCHES", dict.fromkeys(ops.LAUNCHES, 0))
    for _ in range(3):
        ops._launch("l2_rows", 1, 2, 3)
    assert calls == ["l2_rows"] and ops.LAUNCHES["l2_rows"] == 3
    for _ in range(2):
        with pytest.raises(RuntimeError, match="error 719"):
            ops._launch("adc_rows", 4)
    assert calls == ["l2_rows", "adc_rows"] and ops.LAUNCHES["adc_rows"] == 0


def test_wrappers_check_devices_and_prune_operands():
    """The device check refuses mixed and unsupported devices, and the
    prune wrapper its table's dtype, rank and the block's
    shapes."""
    d_p, table, ids, ok = (torch.from_numpy(a) for a in _prune_rows(
        1, 2, 6, 4, "integer"))
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="several devices"):
        ops.l2_rows(torch.zeros((2, 8)), meta,
                    torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.l2_rows(meta, meta, torch.zeros((2, 3), dtype=torch.int32,
                                            device="meta"))
    with pytest.raises(TypeError):
        ops.robust_prune_fp(d_p, table.double(), ids, ok, alpha=1.2, R=3)
    with pytest.raises(ValueError):
        ops.robust_prune_fp(d_p, table[None], ids, ok, alpha=1.2, R=3)
    with pytest.raises(ValueError, match="mismatched"):
        ops.robust_prune_fp(d_p[:, :5], table, ids, ok, alpha=1.2, R=3)
