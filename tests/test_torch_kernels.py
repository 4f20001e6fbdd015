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
import re
from pathlib import Path

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


FS_THREADS = 128                # frontier_select.cu's kThreads


def _sort_key(d: float, pos: int) -> int:
    """frontier_select.cu's ``sort_key``: the distance's bits in unsigned
    order (-0 as +0) above the position."""
    u = 0 if d == 0 else int(np.float32(d).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | pos


def _emulate_frontier_select(cand_ids, cand_d, new_ids, new_d, vis_ids,
                             vis_d, vis_cnt, *, W, max_visits):
    """frontier_select.cu's steps for each row, in numpy: warp w compacts
    the lanes below +inf of its 32-lane chunks (w, w + 4, ...) into its
    own segment of slots; each kept entry's rank is the count of kept keys
    below it (entry e found at its slot as the kernel computes it), and
    ranks < L are scattered, the rest of the merged list
    filled with (-1, +inf); warps test the open mask on 32 merged entries
    each (lanes striding over the visited set, a vote), a block scan of the
    warps' ballots ranks the open entries (carried over passes of 128), and
    the first ``allowed`` are the frontier and the visited append.  Outputs
    start as garbage, so an entry the kernel would not write shows."""
    warps = FS_THREADS // 32
    B, L = cand_ids.shape
    M = L + new_ids.shape[1]
    V = vis_ids.shape[1]
    nch = -(-M // 32)
    seg = -(-nch // warps) * 32
    m_ids = np.full((B, L), 7777, np.int32)
    m_d = np.full((B, L), np.nan, np.float32)
    f_ids = np.full((B, W), 7777, np.int32)
    f_d = np.full((B, W), np.nan, np.float32)
    ov_ids = np.full((B, V), 7777, np.int32)
    ov_d = np.full((B, V), np.nan, np.float32)
    ov_cnt = np.full(B, 7777, np.int32)
    for b in range(B):
        ids = np.concatenate([cand_ids[b], new_ids[b]])
        d = np.concatenate([cand_d[b], new_d[b]])
        slots = {}                                   # slot -> lane
        for w in range(warps):
            n_w = 0
            for ch in range(w, nch, warps):
                lanes = [i for i in range(ch * 32, min(ch * 32 + 32, M))
                         if d[i] < np.inf]           # ballot; popc offsets
                for j, i in enumerate(lanes):
                    slots[w * seg + n_w + j] = i
                n_w += len(lanes)
            assert n_w <= seg
        # Kept entry e (in segment order) sits at slot e plus the unused
        # slots of the segments before its own.
        w_n = [sum(1 for s_ in slots if s_ // seg == w) for w in range(warps)]
        pre = np.cumsum([0] + w_n)
        lanes = [slots[e + sum(seg - w_n[w - 1] for w in range(1, warps)
                               if e >= pre[w])] for e in range(len(slots))]
        keys = np.array([_sort_key(d[i], i) for i in lanes], dtype=np.uint64)
        rank = (keys[None, :] < keys[:, None]).sum(1)
        mid = np.full(L, 7777, np.int32)
        md = np.full(L, np.nan, np.float32)
        for r, i in zip(rank, lanes):
            if r < L:
                mid[r] = ids[i] if np.isfinite(d[i]) else -1
                md[r] = d[i]
        n_kept = len(slots)
        m_ids[b], m_d[b] = mid, md
        m_ids[b, n_kept:], m_d[b, n_kept:] = -1, np.inf
        n_m = min(n_kept, L)
        cnt0 = int(vis_cnt[b])
        allowed = min(W, max_visits - cnt0)
        carry = 0
        for base in range(0, n_m, FS_THREADS):
            opens = []
            for w in range(warps):
                e0 = base + 32 * w
                flags = [False] * 32
                for j in range(min(32, max(n_m - e0, 0))):
                    idj = mid[e0 + j]
                    seen = idj >= 0 and any(
                        (vis_ids[b, lane::32] == idj).any()
                        for lane in range(32))           # __any_sync
                    flags[j] = bool(idj >= 0 and not seen)
                opens.append(flags)
            totals = [sum(f) for f in opens]
            for w in range(warps):
                before = carry + sum(totals[:w])
                for lane, is_open in enumerate(opens[w]):
                    r = before + sum(opens[w][:lane])
                    if is_open and r < allowed:
                        e = base + 32 * w + lane
                        f_ids[b, r], f_d[b, r] = mid[e], md[e]
                        if 0 <= cnt0 + r < V:
                            ov_ids[b, cnt0 + r] = mid[e]
                            ov_d[b, cnt0 + r] = md[e]
            carry += sum(totals)
        n_take = max(0, min(carry, allowed))
        f_ids[b, n_take:], f_d[b, n_take:] = -1, np.inf
        for v in range(V):
            if not 0 <= v - cnt0 < n_take:
                ov_ids[b, v], ov_d[b, v] = vis_ids[b, v], vis_d[b, v]
        ov_cnt[b] = cnt0 + n_take
    return m_ids, m_d, f_ids, f_d, ov_ids, ov_d, ov_cnt


def _frontier_case(case):
    """(args, W, max_visits) for one walk case."""
    if case == "two_passes":            # L + K > 384 and L > 128
        return _frontier_rows(11, 3, 140, 300, 200, "integer"), 16, 200
    if case == "main_widths":
        return _frontier_rows(12, 2, 100, 256, 166, "uniform"), 4, 166
    L, K, V, W = 16, 24, 30, 4
    args = _frontier_rows(13, 6, L, K, V, "integer", nvis_frac=0.3)
    if case == "all_inf_row":
        args[1][2] = np.inf
        args[3][2] = np.inf
    elif case == "w_over_open":         # one open entry in row 0, W 8
        args[0][0], args[1][0] = -1, np.inf
        args[0][0, 3], args[1][0, 3] = 4242, 2.0
        args[3][0] = np.inf
        W = 8
    elif case == "full_visited":        # row 1 at its visit budget
        args[4][1] = np.arange(20_000, 20_000 + V, dtype=np.int32)
        args[5][1] = 1.0
        args[6][1] = V
    elif case == "unsorted":            # the list in any order, gaps too
        g = np.random.default_rng(5)
        for b in range(args[0].shape[0]):
            perm = g.permutation(L)
            args[0][b], args[1][b] = args[0][b, perm], args[1][b, perm]
    elif case == "minus_inf_and_zeros":
        g = np.random.default_rng(6)
        for a in (args[1], args[3]):
            fin = np.isfinite(a)
            a[fin & (g.random(a.shape) < 0.3)] = 0.0
            a[fin & (g.random(a.shape) < 0.2)] = -0.0
            a[fin & (g.random(a.shape) < 0.05)] = -np.inf
    return args, W, V


@pytest.mark.parametrize("case", ["integer_ties", "all_inf_row",
                                  "w_over_open", "full_visited", "unsorted",
                                  "minus_inf_and_zeros", "two_passes",
                                  "main_widths"])
def test_frontier_select_kernel_walk_matches_contract(case):
    """frontier_select.cu's compaction, rank count, scatter, open test and
    block scan (emulated in numpy) give the contract's seven outputs bit
    for bit: integer distances with ties everywhere, an all-+inf row, W
    past the open entries, a full visited set, an unsorted candidate list,
    -inf and signed zeros, two rank and scan passes, and the main path's
    widths L 100, K 256, V 166, W 4."""
    args, W, max_visits = _frontier_case(case)
    want = ref.frontier_select_batch_ref(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args], W=W,
        max_visits=max_visits)
    got = _emulate_frontier_select(*args, W=W, max_visits=max_visits)
    for w, g, name in zip(want, got, ["m_ids", "m_d", "f_ids", "f_d",
                                      "vis_ids", "vis_d", "vis_cnt"]):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
        assert g.dtype == w.numpy().dtype, name
    if case == "w_over_open":
        assert list(got[2][0]) == [4242] + [-1] * 7
    elif case == "full_visited":
        assert (got[2][1] == -1).all() and got[6][1] == 30
    elif case == "all_inf_row":
        assert (got[0][2] == -1).all() and np.isinf(got[1][2]).all()


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
                    # alpha * cover in f32, as the kernel's product
                    if c == star or (np.float32(alpha)
                                     * np.float32(cover[c])) <= key[c]:
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


def _repair_graph_cases(seed, N, R, d):
    """An integer repair fixture over N slots whose first four nodes are
    the walk's cases: node 0 has every neighbour deleted (the widest
    list), node 1 none, node 2 a deleted neighbour but is not usable, and
    node 3 one deleted neighbour whose row names only node 3 (repaired, no
    candidate survives compaction)."""
    g = np.random.default_rng(seed)
    adj = g.integers(0, N, (N, R)).astype(np.int32)
    adj[g.random((N, R)) < 0.1] = -1
    deleted = g.random(N) < 0.05
    usable = ~deleted & (g.random(N) > 0.02)
    deleted[adj[0][adj[0] >= 0]] = True
    q = N - 1
    adj[3] = -1
    adj[3, 5] = q
    adj[q] = -1
    adj[q, :2] = 3
    deleted[q] = True
    deleted[:4] = False
    usable[[0, 1, 3]] = True
    usable[2] = False
    adj[2, 0] = q
    live = np.flatnonzero(~deleted)
    adj[1] = g.choice(live[live > 3], R)
    table = g.integers(-3, 4, (N, d)).astype(np.float32)
    return adj, deleted, usable, table


def _repair_resident(n, arena, d):
    """delete_repair_fp.cu's ``resident``: the rows that fit in the arena
    after n ids and keys (8 bytes each, padded to 16)."""
    row = -(-d // 4) * 16
    return min(n, (arena - -(-n * 8 // 16) * 16) // row)


def _emulate_delete_repair_fp(adj, deleted, usable, table, node_ids, *,
                              alpha, R, arena):
    """delete_repair_fp.cu's walk for each node, in torch: out-of-range
    nodes give -1 rows; a node that is not usable or has no deleted
    neighbour keeps its row (the early exit); otherwise the candidate
    lanes (kept edges, then the deleted neighbours' rows) are compacted in
    column order, the first ``resident(n)`` rows are staged and the rest
    read from the table (the tiled path), the anchor distances are the
    elementwise ones, and the rounds are robust_prune_fp's walk.  Returns
    the rows and each repaired node's (n, resident rows), None for the
    others."""
    N = adj.shape[0]
    out = torch.full((len(node_ids), R), 7777, dtype=torch.int32)
    sizes = []
    for b, p in enumerate(node_ids.tolist()):
        if not 0 <= p < N:
            out[b] = -1
            sizes.append(None)
            continue
        row = adj[p].tolist()
        par = [k for k, v in enumerate(row) if 0 <= v < N and deleted[v]]
        if not par or not usable[p]:
            out[b] = adj[p]
            sizes.append(None)
            continue
        lanes = [v for v in row if 0 <= v < N and not deleted[v]]
        for k in par:
            lanes += [v for v in adj[row[k]].tolist() if 0 <= v < N]
        cid = [v for v in lanes if usable[v] and v != p]
        n = len(cid)
        n_res = _repair_resident(n, arena, table.shape[1])
        sizes.append((n, n_res))
        ids = torch.tensor([cid], dtype=torch.int32).reshape(1, n)
        d_p = ((table[p][None] - table[ids[0].long()]) ** 2).sum(-1)[None]
        ok = torch.ones((1, n), dtype=torch.bool)
        new, _ = _emulate_prune_fp(d_p, table, ids, ok, alpha=alpha, R=R,
                                   n_res=n_res)
        out[b] = new[0]
    return out, sizes


@pytest.mark.parametrize("R,d,arena_rows", [
    (16, 8, None),                   # every list resident
    (16, 8, 3),                      # three rows past the lane state
    (8, 7, 0),                       # no row resident; d not a multiple of 4
    (12, 20, 40)])
def test_delete_repair_fp_kernel_walk_matches_contract(R, d, arena_rows):
    """delete_repair_fp.cu's early exit, column-order compaction, arena
    split into resident and tiled rows and the shared rounds (emulated in
    torch) give the contract's rows on integer inputs: a node with no
    deleted neighbour and one that is not usable keep their rows, a node
    left with no candidate gets an INVALID row, the widest list runs past
    the resident rows when the arena holds few."""
    N = 400
    adj, deleted, usable, table = _repair_graph_cases(R * d, N, R, d)
    g = np.random.default_rng(R + d)
    node_ids = np.concatenate([[0, 1, 2, 3, -1, N],
                               g.integers(0, N, 40)]).astype(np.int32)
    t = [torch.from_numpy(x) for x in (adj, deleted, usable, table)]
    widest = (R + R * R) * 8
    row = -(-d // 4) * 16
    arena = widest + (0 if arena_rows is None else arena_rows) * row
    if arena_rows is None:
        arena += (R + R * R) * row
    got, sizes = _emulate_delete_repair_fp(
        *t, torch.from_numpy(node_ids), alpha=1.2, R=R, arena=arena)
    ids = torch.from_numpy(node_ids[:4].copy())
    want = ref.delete_repair_fp_ref(*ref.repair_operands_fp(*t, ids),
                                    alpha=1.2, R=R)
    assert torch.equal(got[:4], want)
    inside = torch.from_numpy(node_ids[6:].copy())
    want = ref.delete_repair_fp_ref(*ref.repair_operands_fp(*t, inside),
                                    alpha=1.2, R=R)
    assert torch.equal(got[6:], want)
    assert (got[4:6] == -1).all()
    assert torch.equal(got[1], t[0][1]) and torch.equal(got[2], t[0][2])
    assert sizes[1] is None and sizes[2] is None
    assert sizes[3] == (0, 0) and (got[3] == -1).all()
    n0, res0 = sizes[0]
    assert n0 > R and not torch.equal(got[0], t[0][0])
    assert (res0 < n0) == (arena_rows is not None)


def _sdc_sums(tables, a, cc):
    """sum_j T[j, a_j, cc[:, j]] for each code row of cc, in j order in
    f32 (the kernels' m loads a candidate, added one after another)."""
    acc = np.zeros(len(cc), np.float32)
    for j in range(tables.shape[0]):
        acc = (acc + tables[j, a[j], cc[:, j]]).astype(np.float32)
    return acc


def _sdc_block_rounds(tables, rows, emit, dp, alive, *, alpha, R, threads):
    """prune_rounds_sdc.cuh's block_rounds over one list, in numpy: column
    c (code row ``rows[c]``, emitted id ``emit[c]``) owned by thread
    c % ``threads`` with an alive flag; the first winner is the least
    (dp, column) among the alive columns; each round emits the winner's
    id, scores every other alive column against it with m table reads a
    candidate summed in j order (no staged slice), retires what it
    alpha-covers, and each thread folds the least (dp, column) of its
    surviving columns into its cover pass, the block's least of those the
    next winner.  ``alive`` is updated in place.  Returns the ids
    emitted."""
    a32 = np.float32(alpha)
    n = len(dp)
    best = min(((dp[c], c) for c in range(n) if alive[c]),
               default=(np.inf, n))
    out = []
    while len(out) < R and best[0] < np.inf:
        star = best[1]
        out.append(emit[star])
        cover = _sdc_sums(tables, rows[star], rows)
        mine = []
        for t in range(threads):
            cols = [c for c in range(t, n, threads) if alive[c]]
            for c in cols:
                alive[c] = c != star and not a32 * cover[c] <= dp[c]
            own = [(dp[c], c) for c in cols if alive[c]]
            if own:
                mine.append(min(own))
        best = min(mine, default=(np.inf, n))
    return out


def _emulate_delete_repair_sdc(adj, deleted, usable, codes, tables,
                               node_ids, *, alpha, R, cap, threads=256):
    """delete_repair_sdc.cu's walk for each node, in numpy: out-of-range
    nodes give -1 rows; a node that is not usable or has no deleted
    neighbour keeps its row (the early exit); otherwise the candidate lanes
    (kept edges, then the rows of the FIRST ``cap`` deleted neighbours in
    column order) are compacted in column order, the anchor distances are
    m table reads a candidate summed in j order, and the block's rounds
    (``_sdc_block_rounds``) run over the candidates' code-table rows,
    emitting their ids.  Returns the rows and, for each repaired node,
    (deleted neighbours, candidates n, alive after the anchor pass), None
    for the others."""
    N = adj.shape[0]
    out = np.full((len(node_ids), R), 7777, np.int32)
    sizes = []
    for b, p in enumerate(node_ids.tolist()):
        if not 0 <= p < N:
            out[b] = -1
            sizes.append(None)
            continue
        row = adj[p].tolist()
        dels = [k for k, v in enumerate(row) if 0 <= v < N and deleted[v]]
        if not dels or not usable[p]:
            out[b] = adj[p]
            sizes.append(None)
            continue
        lanes = [v for v in row if 0 <= v < N and not deleted[v]]
        for k in dels[:cap]:
            lanes += [v for v in adj[row[k]].tolist() if 0 <= v < N]
        cid = np.array([v for v in lanes if usable[v] and v != p], np.int64)
        n = len(cid)
        dp = _sdc_sums(tables, codes[p], codes[cid]) if n else np.zeros(0)
        alive = np.isfinite(dp)
        sizes.append((len(dels), n, int(alive.sum())))
        new = _sdc_block_rounds(tables, codes[cid], cid, dp, alive,
                                alpha=alpha, R=R, threads=threads)
        out[b, :len(new)] = new
        out[b, len(new):] = -1
    return out, sizes


@pytest.mark.parametrize("threads", [256, 4])
@pytest.mark.parametrize("R,m,ksub,cap", [(16, 8, 16, 3), (8, 4, 16, 4),
                                          (12, 16, 32, 2)])
def test_delete_repair_sdc_kernel_walk_matches_contract(threads, R, m, ksub,
                                                        cap):
    """delete_repair_sdc.cu's early exit, column-order compaction under the
    cap, the cover read straight from the tables in j order and the
    block's rounds (emulated in numpy) give the contract's rows on integer
    inputs, with the kernel's 256 threads and with 4 (each thread then
    owns many columns and folds their argmin, lowest column first): node 0
    has more deleted neighbours than ``cap``; node 1 none and node 2 is not
    usable (both keep their rows); node 3 is repaired but no candidate
    survives compaction, and node 4's candidates all lie in the deleted
    neighbour's row, none of them usable (both get INVALID rows); -1 and N
    are out of range."""
    N = 400
    adj, deleted, usable, _ = _repair_graph_cases(R * m + cap, N, R, 4)
    g = np.random.default_rng(R + m + cap)
    q = N - 2
    adj[4] = -1
    adj[4, 1] = q
    adj[q] = g.choice(np.flatnonzero(~usable & (np.arange(N) > 4)), R)
    deleted[q] = True
    deleted[4] = False
    usable[4] = True
    codes = g.integers(0, ksub, (N, m)).astype(np.uint8)
    tables = g.integers(0, 9, (m, ksub, ksub)).astype(np.float32)
    node_ids = np.concatenate([[0, 1, 2, 3, 4, -1, N],
                               g.integers(0, N, 40)]).astype(np.int32)
    got, sizes = _emulate_delete_repair_sdc(
        adj, deleted, usable, codes, tables, node_ids, alpha=1.2, R=R,
        cap=cap, threads=threads)
    ids = np.delete(node_ids, [5, 6])
    t = [torch.from_numpy(x) for x in (adj, deleted, usable, codes, tables,
                                       ids)]
    want = ref.delete_repair_sdc_ref(*ref.repair_operands_sdc(*t, cap),
                                     alpha=1.2, R=R).numpy()
    np.testing.assert_array_equal(np.delete(got, [5, 6], 0), want)
    assert (got[5:7] == -1).all()
    np.testing.assert_array_equal(got[1:3], adj[1:3])
    assert sizes[1] is None and sizes[2] is None
    assert sizes[0][0] > cap and sizes[0][1] > R
    assert sizes[3] == (1, 0, 0) and (got[3] == -1).all()
    assert sizes[4] == (1, 0, 0) and (got[4] == -1).all()
    assert not np.array_equal(got[0], adj[0])
    if threads < 256:                    # threads own several columns
        assert max(z[1] for z in sizes if z is not None) > 4 * threads


def _emulate_robust_prune_sdc(d_p, codes, tables, ids, ok, *, alpha, R,
                              threads=256):
    """robust_prune_sdc.cu's walk for each row, in numpy: the alive
    candidates are those with ``ok`` and a finite anchor distance, each
    one's code row is staged once from the CLAMPED id (an id < 0 reads row
    0, as the plain version's gather does), and the block's rounds
    (``_sdc_block_rounds``) emit the RAW ids; the rest of the row is -1
    and the count is the ids emitted."""
    B, C = ids.shape
    N = codes.shape[0]
    out = np.full((B, R), 7777, np.int32)
    cnt = np.full(B, 7777, np.int32)
    for b in range(B):
        alive = ok[b] & np.isfinite(d_p[b])
        rows = codes[np.clip(ids[b], 0, N - 1)]
        new = _sdc_block_rounds(tables, rows, ids[b], d_p[b], alive,
                                alpha=alpha, R=R, threads=threads)
        out[b, :len(new)] = new
        out[b, len(new):] = -1
        cnt[b] = len(new)
    return out, cnt


@pytest.mark.parametrize("threads", [256, 4])
@pytest.mark.parametrize("B,C,m,ksub,R,alpha", [(4, 40, 8, 16, 8, 1.2),
                                                (3, 300, 8, 16, 24, 1.2),
                                                (3, 67, 5, 32, 16, 1.0)])
def test_robust_prune_sdc_kernel_walk_matches_contract(threads, B, C, m,
                                                       ksub, R, alpha):
    """robust_prune_sdc.cu's staged code rows, raw-id/clamped-row split and
    the block's rounds (emulated in numpy) give the contract's rows and
    counts, and the Pallas kernel's (interpret mode), on integer inputs
    with ties, duplicate ids, ``ok`` true on ids of -1 (which emit -1 and
    cover with row 0's code), +-inf and NaN anchor distances (never alive)
    and an all-masked row; with the kernel's 256 threads and with 4 (each
    thread then owns several columns); C 300 has more columns than the
    kernel's threads."""
    g = np.random.default_rng(C * m + R)
    N = 90
    codes = g.integers(0, ksub, (N, m)).astype(np.uint8)
    tables = g.integers(0, 9, (m, ksub, ksub)).astype(np.float32)
    ids = g.integers(0, N, (B, C)).astype(np.int32)
    ids[:, C // 2:C // 2 + C // 8] = ids[:, :C // 8]         # duplicates
    ids[g.random((B, C)) < 0.15] = -1
    ok = g.random((B, C)) > 0.15                  # true on some ids of -1
    ok[0] = False                                 # no winner at all
    d_p = g.integers(0, 6 * m, (B, C)).astype(np.float32)
    d_p[1, :4] = [np.inf, np.nan, -np.inf, np.nan]
    ok[1, :4] = True
    got = _emulate_robust_prune_sdc(d_p, codes, tables, ids, ok, alpha=alpha,
                                    R=R, threads=threads)
    t = [torch.from_numpy(x) for x in (d_p, codes[np.maximum(ids, 0)],
                                       tables, ids, ok)]
    want = ref.robust_prune_sdc_ref(*t, alpha=alpha, R=R)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    w_ids, w_cnt = jops.robust_prune_sdc(
        jnp.asarray(d_p), jnp.asarray(codes[np.maximum(ids, 0)].astype(
            np.int32)), jnp.asarray(tables), jnp.asarray(ids),
        jnp.asarray(ok), alpha=alpha, R=R, use_kernel=True)
    np.testing.assert_array_equal(got[0], np.asarray(w_ids))
    np.testing.assert_array_equal(got[1], np.asarray(w_cnt))
    emitted = got[0][np.arange(R)[None] < got[1][:, None]]
    assert got[1][0] == 0 and (got[0][0] == -1).all()
    assert (emitted == -1).any()                  # an ok id of -1 won
    assert got[1][1:].min() > 0
    if C > 256:
        assert got[1].max() > 1


def _persistent_grid(B, slots):
    """adc_rows.cu's ``persistent_grid``: ceil(B / slots) turns a block,
    the blocks spread evenly over them."""
    turns = -(-B // slots)
    return -(-B // turns)


def _emulate_adc_rows(luts, codes, ids, *, slots, loop_slots,
                      optin=232448, threads=256, per_thread=2):
    """adc_rows.cu's dispatch and walk, in numpy: the bulk path when m % 16
    == 0, m * ksub * 4 % 16 == 0, the LUTs and codes are 16-byte aligned
    (``data_ptr``), B is past one wave of the loop kernel (``loop_slots``
    resident blocks) and two LUTs fit a block (``slots`` resident bulk
    blocks), else the loop kernel (one block a query).  On the bulk path,
    block g of the persistent grid
    scores queries g, g + G, ... on buffer t % 2 at mbarrier parity
    (t // 2) % 2; the first two copies are issued at the start and each
    buffer is refilled two turns ahead once scored (the walk checks that a
    turn finds its own query's LUT there); a thread takes candidates
    k0 + u * threads + tid, u < per_thread, for k0 in steps of
    per_thread * threads.  Sums are in j order in f32; ids < 0 or >= N
    give +inf.  Returns (out, path, {block: [(query, buffer, parity)]})."""
    B, m, ksub = luts.shape
    K = ids.shape[1]
    N = codes.shape[0]
    lut_np, codes_np, ids_np = luts.numpy(), codes.numpy(), ids.numpy()
    out = np.full((B, K), np.nan, np.float32)

    def score(q, lut, ks):
        idk = ids_np[q, ks]
        ok = (idk >= 0) & (idk < N)
        acc = np.zeros(len(ks), np.float32)
        cc = codes_np[np.where(ok, idk, 0)]
        for j in range(m):
            acc = (acc + lut[j, cc[:, j]]).astype(np.float32)
        assert np.isnan(out[q, ks]).all()            # each lane once
        out[q, ks] = np.where(ok, acc, np.inf)

    bulk = (m % 16 == 0 and codes.data_ptr() % 16 == 0
            and m * ksub * 4 % 16 == 0 and luts.data_ptr() % 16 == 0
            and B > loop_slots and 2 * m * ksub * 4 + 16 <= optin)
    if not bulk:
        for q in range(B):
            score(q, lut_np[q], np.arange(K))
        return out, "loop", {}
    G = _persistent_grid(B, slots)
    turns = {}
    for g in range(G):
        buf = [None, None]
        for s in range(2):
            if g + s * G < B:
                buf[s] = g + s * G
        t, q = 0, g
        while q < B:
            s = t % 2
            assert buf[s] == q
            turns.setdefault(g, []).append((q, s, (t // 2) % 2))
            for k0 in range(0, K, per_thread * threads):
                for u in range(per_thread):
                    ks = k0 + u * threads + np.arange(threads)
                    score(q, lut_np[buf[s]], ks[ks < K])
            if q + 2 * G < B:
                buf[s] = q + 2 * G
            t, q = t + 1, q + G
    return out, "bulk", turns


@pytest.mark.parametrize("B,K,m,ksub,slots,layout,path", [
    (10, 37, 16, 32, 4, "aligned", "bulk"),     # 3 turns, the last partial
    (7, 300, 32, 16, 3, "aligned", "bulk"),     # K past the thread count
    (5, 1100, 16, 8, 8, "aligned", "bulk"),     # three candidate chunks
    (3, 20, 16, 16, 396, "aligned", "bulk"),    # one turn, blocks idle
    (2, 20, 16, 16, 396, "aligned", "loop"),    # within one loop wave
    (1, 20, 16, 16, 396, "aligned", "loop"),    # B 1
    (6, 50, 4, 16, 4, "aligned", "loop"),       # m % 16 != 0
    (6, 50, 16, 16, 4, "codes offset", "loop"),  # misaligned codes
    (6, 50, 16, 16, 4, "luts offset", "loop"),  # misaligned LUTs
    (4, 50, 128, 256, 4, "aligned", "loop")])   # two LUTs past a block
def test_adc_rows_kernel_walk_matches_contract(B, K, m, ksub, slots, layout,
                                               path):
    """adc_rows.cu's dispatch, persistent schedule and candidate chunks
    (emulated in numpy, the loop kernel holding 2 resident blocks) give
    the contract's distances on integer inputs: every query is scored
    once, by block q % G on turn q // G, each turn finds its query's LUT in
    its buffer, and every lane is written once; a B within one wave of the
    loop kernel and the layouts the bulk copy cannot take run the loop
    kernel."""
    g = np.random.default_rng(B * K + m)
    N = 90
    lut_np = g.integers(0, 20, (B, m, ksub)).astype(np.float32)
    codes_np = g.integers(0, ksub, (N, m)).astype(np.uint8)
    ids = torch.from_numpy(g.integers(-1, N + 1, (B, K)).astype(np.int32))
    luts = torch.from_numpy(lut_np)
    codes = torch.from_numpy(codes_np)
    if layout == "codes offset":
        flat = torch.zeros(N * m + 16, dtype=torch.uint8)
        codes = flat[1:1 + N * m].view(N, m)
        codes.copy_(torch.from_numpy(codes_np))
    elif layout == "luts offset":
        flat = torch.zeros(B * m * ksub + 4)
        luts = flat[1:1 + B * m * ksub].view(B, m, ksub)
        luts.copy_(torch.from_numpy(lut_np))
    else:
        assert luts.data_ptr() % 16 == 0 and codes.data_ptr() % 16 == 0
    got, took, turns = _emulate_adc_rows(luts, codes, ids, slots=slots,
                                         loop_slots=2)
    assert took == path
    want = ref.adc_rows_ref(luts, codes, ids.clamp(max=N - 1).where(
        ids < N, torch.tensor(-1, dtype=torch.int32))).numpy()
    np.testing.assert_array_equal(got, want)
    if path == "bulk":
        G = _persistent_grid(B, slots)
        assert G <= slots
        assert sorted(q for t in turns.values() for q, _, _ in t) == list(
            range(B))
        for blk, seq in turns.items():
            assert [q for q, _, _ in seq] == list(range(blk, B, G))
            assert [(s, par) for _, s, par in seq] == [
                (t % 2, (t // 2) % 2) for t in range(len(seq))]
        assert len({len(t) for t in turns.values()}) == (1 if B % G == 0
                                                         else 2)


def _cu_constants(name, *consts):
    """The values of ``constexpr int`` constants in ``csrc/<name>.cu``."""
    src = (Path(ops.__file__).parent / "csrc" / f"{name}.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {c} = (\d+);", src).group(1))
                 for c in consts)


# l2_rows.cu's constants: warps a block, rows a lane group loads at once,
# 4-float chunks of a row a lane loads at once.
_L2_MAX_WARPS, _L2_ROWS_PER_GROUP, _L2_CHUNKS_PER_LANE = _cu_constants(
    "l2_rows", "kMaxWarps", "kRowsPerGroup", "kChunksPerLane")


def _l2_plan(d, K):
    """l2_rows.cu's launch: (chunks a row, lanes a row G, warps a block,
    pairs a tile, tiles a query)."""
    nc = -(-d // 4)
    G = 1
    while G < 32 and G * _L2_CHUNKS_PER_LANE < nc:
        G *= 2
    rows_per_warp = _L2_ROWS_PER_GROUP * 32 // G
    warps = min(_L2_MAX_WARPS, -(-K // rows_per_warp))
    tile = warps * rows_per_warp
    return nc, G, warps, tile, -(-K // tile)


def _fma32(a, b, c):
    """One f32 fma (the f64 product of two f32s is exact; the f64 sum then
    rounds twice, which never shows on integer inputs)."""
    return np.float32(float(a) * float(b) + float(c))


def _emulate_l2_rows(q, table, ids):
    """l2_rows.cu's walk in numpy: the route from d and the table's address
    (16-byte loads when d % 4 == 0 and it is 16-byte aligned, 8-byte when
    d % 2 == 0 and 8-byte aligned, else 4-byte; each load checked for its
    alignment and for staying inside its row); block g serves query g //
    tiles, pairs (g % tiles) * tile ...; q staged zero-padded to whole
    chunks and the tile's ids read once; warp w's group p takes rows w * 2
    * (32 / G) + u * (32 / G) + p, u < 2; lane l of a group sums chunks l,
    l + G, ... in order, fma by fma, floats past d read as 0; the group's
    butterfly; |q|^2 by the same walk; ids < 0 or >= N give +inf.
    Returns (out, route, {(b, k): [G, 2] lane sums (q.x, |x|^2) before the
    butterfly})."""
    B, d = q.shape
    N, K = table.shape[0], ids.shape[1]
    nc, G, warps, tile, tiles = _l2_plan(d, K)
    groups = 32 // G
    base = table.data_ptr()
    V = (4 if d % 4 == 0 and base % 16 == 0
         else 2 if d % 2 == 0 and base % 8 == 0 else 1)
    tab, qn, idn = table.numpy(), q.numpy(), ids.numpy()
    zero = np.zeros(4, np.float32)
    out = np.full((B, K), np.nan, np.float32)
    id_reads = np.zeros((B, K), int)
    partials = {}

    def load_chunk(row, c):
        v = zero.copy()
        j = 4 * c
        for s in range(0, 4, V):
            if j + s < d:
                assert j + s + V <= d                      # inside the row
                assert (base + 4 * (row * d + j + s)) % (4 * V) == 0
                v[s:s + V] = tab[row, j + s:j + s + V]
        return v

    def lane_sums(chunk, qs):
        sums = np.zeros((G, 2), np.float32)
        for gl in range(G):
            qx = xx = np.float32(0)
            for cb in range(0, nc, G * _L2_CHUNKS_PER_LANE):
                for i in range(_L2_CHUNKS_PER_LANE):
                    c = cb + i * G + gl
                    x = chunk(c)
                    a = qs[c] if c < nc else zero
                    for e in range(4):
                        qx = _fma32(x[e], a[e], qx)
                        xx = _fma32(x[e], x[e], xx)
            sums[gl] = qx, xx
        return sums

    def group_sum(v):
        o = G // 2
        while o:
            v = (v + v[np.arange(G) ^ o]).astype(np.float32)
            o //= 2
        assert (v == v[0]).all()                 # every lane the same bits
        return v[0]

    for blk in range(B * tiles):
        b, k0 = blk // tiles, blk % tiles * tile
        kn = min(tile, K - k0)
        qs = np.zeros((nc, 4), np.float32)
        qs.reshape(-1)[:d] = qn[b]
        id_s = np.full(tile, -1)
        for t in range(kn):
            id_reads[b, k0 + t] += 1
            i = int(idn[b, k0 + t])
            id_s[t] = i if 0 <= i < N else -1
        qq = group_sum(lane_sums(lambda c: qs[c] if c < nc else zero,
                                 qs)[:, 1])
        for w in range(warps):
            for p in range(groups):
                for u in range(_L2_ROWS_PER_GROUP):
                    r = w * _L2_ROWS_PER_GROUP * groups + u * groups + p
                    row = id_s[r]
                    sums = lane_sums(
                        lambda c: load_chunk(row, c) if row >= 0 else zero,
                        qs)
                    qx, xx = group_sum(sums[:, 0]), group_sum(sums[:, 1])
                    if r >= kn:
                        continue
                    assert np.isnan(out[b, k0 + r])      # each output once
                    partials[(b, k0 + r)] = sums
                    out[b, k0 + r] = (np.inf if row < 0 else np.maximum(
                        _fma32(-2.0, qx, qq) + xx, np.float32(0)))
    assert (id_reads == 1).all() and not np.isnan(out).any()
    return out, V, partials


@pytest.mark.parametrize("kind,d,B,K,offsets,routes", [
    ("integer", 1, 2, 70, (0,), (1,)),          # G 1, one lane a row
    ("integer", 3, 3, 40, (0,), (1,)),
    ("integer", 7, 2, 50, (0,), (1,)),          # a chunk and a partial one
    ("integer", 50, 3, 37, (0,), (2,)),         # d 50: 8-byte loads, G 4
    ("integer", 100, 2, 40, (0,), (4,)),
    ("integer", 128, 1, 150, (0,), (4,)),       # B 1, K past two tiles
    ("integer", 130, 2, 33, (0,), (2,)),        # G 16, a tile of 1
    ("integer", 600, 1, 5, (0,), (4,)),         # two chunk batches a lane
    ("integer", 128, 2, 40, (4, 8), (1, 2)),    # table views off 16 bytes
    ("integer", 50, 2, 40, (4,), (1,)),
    ("gaussian", 128, 2, 20, (0, 8, 4), (4, 2, 1)),   # one walk, 3 widths
    ("gaussian", 50, 2, 20, (0, 4), (2, 1))])
def test_l2_rows_kernel_walk_matches_contract(kind, d, B, K, offsets,
                                              routes):
    """l2_rows.cu's tiles, lane groups, load width and tail masks
    (emulated in numpy) give the contract's distances: equal to the plain
    version on integer inputs (ids of -1 and >= N give +inf), within the
    Gaussian tolerance on real ones; the same pairs read from the table at
    a 4- or 8-byte offset take the narrower loads and give every lane the
    same partial sums, element for element, and the same outputs."""
    g = np.random.default_rng(d * 100 + K)
    N = 90
    q_np = _vals(g, kind, (B, d))
    tab_np = _vals(g, kind, (N, d))
    ids_np = g.integers(-1, N + 3, (B, K)).astype(np.int32)
    ids_np[0, :2] = (-1, N)
    ids_np[-1, -1] = N + 2
    ids = torch.from_numpy(ids_np)
    q = torch.from_numpy(q_np)
    want = ref.l2_rows_ref(q, torch.from_numpy(tab_np), ids.where(
        ids < N, torch.tensor(-1, dtype=torch.int32))).numpy()
    runs = []
    for off, route in zip(offsets, routes):
        flat = torch.zeros(N * d + 4)
        table = flat[off // 4:off // 4 + N * d].view(N, d)
        table.copy_(torch.from_numpy(tab_np))
        assert table.data_ptr() % 16 == off
        got, took, partials = _emulate_l2_rows(q, table, ids)
        assert took == route
        if kind == "integer":
            np.testing.assert_array_equal(got, want)
        else:
            fin = np.isfinite(want)
            assert (np.isfinite(got) == fin).all()
            scale = ((q_np * q_np).sum(1)[:, None]
                     + (tab_np * tab_np).sum(1)[np.clip(ids_np, 0, N - 1)])
            assert (np.abs(got[fin] - want[fin])
                    <= 1e-5 * np.abs(want[fin]) + 1e-4 * scale[fin]).all()
        runs.append((got, partials))
    for got, partials in runs[1:]:
        np.testing.assert_array_equal(got, runs[0][0])
        assert partials.keys() == runs[0][1].keys()
        for key, sums in partials.items():
            np.testing.assert_array_equal(sums, runs[0][1][key])


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


def _emulate_block_topk(d, ids, k, *, vec, batch=16):
    """block_topk.cu's warp for each row, in numpy.  Lane l meets its
    columns in batches of ``batch`` values: the float4s i = b0 + l + 32 u
    as columns 4i..4i+3 (``vec``: N % 4 == 0, N >= 512 and 16-byte
    aligned rows), else the columns b0 + l + 32 t.  For k <= 8 (a register
    list) and more than 32 units a row, the first batch sets a bound, the
    k-th least of the lanes' minima.  A value is a candidate below the
    lane's k-th best and at or below the bound (a NaN flags the row);
    candidates are inserted in column order, the k-th best re-read before
    each.  Then k rounds: the least head over the lanes, -0.0 equal to
    +0.0, the lowest column among equal heads.  Returns (values, ids) and
    the count of values that were not candidates.  A row of at most 32
    values (single-value path) skips batches and lists: lane l holds
    column l."""
    Q, N = d.shape
    per = 4 if vec else 1
    upb = batch // per                      # units a lane loads a batch
    out_d = np.full((Q, k), 7.0, np.float32)
    out_i = np.full((Q, k), 7777, np.int32)
    rejected = 0
    for q in range(Q):
        lists = [[] for _ in range(32)]     # (value, column), ascending
        nan, bound = False, np.inf
        units = N // 4 if vec else N
        if not vec and N <= 32:             # a value a lane, no batches
            nan = bool(np.isnan(d[q]).any())
            lists = [[(d[q, c], c)] if c < N and d[q, c] < np.inf else []
                     for c in range(32)]
            units = 0
        for b0 in range(0, units, 32 * upb):
            cols = [[per * (b0 + lane + 32 * u) + j for u in range(upb)
                     if b0 + lane + 32 * u < units for j in range(per)]
                    for lane in range(32)]
            if k <= 8 and b0 == 0 and units > 32:
                mins = sorted(min([d[q, c] for c in cs
                                   if not np.isnan(d[q, c])],
                                  default=np.inf) for cs in cols)
                bound = mins[k - 1]
            for lane, cs in enumerate(cols):
                lst = lists[lane]
                kth = lst[k - 1][0] if len(lst) >= k else np.inf
                cand = [c for c in cs if d[q, c] < kth and d[q, c] <= bound]
                nan |= any(np.isnan(d[q, c]) for c in cs)
                rejected += len(cs) - len(cand)
                for c in cand:
                    kth = lst[k - 1][0] if len(lst) >= k else np.inf
                    if d[q, c] < kth:
                        pos = sum(1 for v, _ in lst if not d[q, c] < v)
                        lst.insert(pos, (d[q, c], c))
                        del lst[k:]
        if nan:
            out_d[q], out_i[q] = np.nan, -1
            continue
        for r in range(k):
            heads = [(lst[0][0], lst[0][1], lane)
                     for lane, lst in enumerate(lists) if lst]
            if not heads:
                out_d[q, r], out_i[q, r] = np.inf, -1
                continue
            wd, wc, wl = min(heads, key=lambda h: (h[0], h[1]))
            lists[wl].pop(0)
            out_d[q, r] = wd
            out_i[q, r] = ids[wc] if np.isfinite(wd) else -1
    return out_d, out_i, rejected


@pytest.mark.parametrize("k", [1, 5, 8, 9, 128])
@pytest.mark.parametrize("N", [15, 20, 2560, 2561])
def test_block_topk_kernel_walk_matches_contract(N, k):
    """block_topk.cu's lane-to-column mapping (float4 and single-value
    paths) in batches, the lanes' bound from their first batch, the
    k-th-best threshold, the lists and the cross-lane merge (emulated in
    numpy) give the contract's values and ids, bit for bit, and the Pallas
    kernel's (interpret mode): integer distances with ties (many at the
    bound), signed zeros (equal, the lowest column first), +-inf (id -1),
    a NaN row ((NaN, -1) throughout) and k > N ((+inf, -1) padding).  N 15,
    20 and 2561 take the single-value loads; N 2560 both paths (an
    unaligned row takes the single-value loads)."""
    g = np.random.default_rng(N + k)
    Q = 3
    d = g.integers(0, 5, (Q, N)).astype(np.float32)
    d[g.random((Q, N)) < 0.1] = np.inf
    d[0, g.choice(N, 2, replace=False)] = -np.inf
    zero = d == 0
    d[zero & (g.random((Q, N)) < 0.5)] = -0.0
    d[2, N // 2] = np.nan
    ids = g.integers(0, 1 << 20, N).astype(np.int32)
    want = ref.block_topk_ref(torch.from_numpy(d), torch.from_numpy(ids), k)
    want = [x.numpy() for x in want]
    pallas = _topk_jax(d, ids, k)
    for vec in ([True, False] if N % 4 == 0 and N >= 512 else [False]):
        got_d, got_i, rejected = _emulate_block_topk(d, ids, k, vec=vec)
        np.testing.assert_array_equal(got_i, want[1])
        np.testing.assert_array_equal(got_d.view(np.int32),
                                      want[0].view(np.int32))
        np.testing.assert_array_equal(got_i, pallas[1])
        np.testing.assert_array_equal(got_d, pallas[0])
        if N >= 2560 and k <= 8:
            assert rejected > 0.6 * Q * N     # most values: one compare
    assert np.isnan(want[0][2]).all() and (want[1][2] == -1).all()
    assert (want[1][0, :2] == -1).all() and np.isneginf(want[0][0, :2]).all()
    assert (want[1][1] >= 0).sum() == min(k, int(np.isfinite(d[1]).sum()))
    if k > N:
        assert np.isposinf(want[0][:2, N:]).all()


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


@pytest.mark.parametrize("bad", range(7))
def test_frontier_select_checks_every_operand(bad):
    """The one-pass operand check still refuses each operand's wrong dtype
    and wrong rank."""
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in _frontier_rows(0, 2, 4, 4, 6, "integer")]
    wrong = list(args)
    wrong[bad] = (args[bad].double() if args[bad].is_floating_point()
                  else args[bad].long())
    with pytest.raises(TypeError):
        ops.frontier_select(*wrong, W=2)
    wrong = list(args)
    wrong[bad] = args[bad][None]
    with pytest.raises(ValueError):
        ops.frontier_select(*wrong, W=2)


@pytest.mark.parametrize("B,L,W,V", [(1024, 100, 4, 166), (3, 7, 1, 5),
                                     (1, 1, 1, 1)])
def test_frontier_outputs_are_aligned_views_of_one_buffer(B, L, W, V):
    """On the card the seven outputs are views of one int32 buffer: each
    starts on a 16-byte boundary, none overlaps another, all fit."""
    views, n = ops._frontier_layout(B, L, W, V)
    assert [v[0] for v in views] == [(B, L), (B, L), (B, W), (B, W),
                                     (B, V), (B, V), (B,)]
    assert [v[3] for v in views] == [False, True] * 3 + [False]
    ends = [off + int(np.prod(shape)) for shape, _, off, _ in views]
    for (shape, stride, off, _), end, nxt in zip(
            views, ends, [v[2] for v in views[1:]] + [n]):
        assert off % 4 == 0 and end <= nxt
        assert stride == ((shape[1], 1) if len(shape) == 2 else (1,))
    buf = torch.arange(n, dtype=torch.int32)
    for shape, stride, off, _ in views:
        v = buf.as_strided(shape, stride, off)
        assert v.is_contiguous() and int(v.reshape(-1)[0]) == off


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
