"""Plain PyTorch versions of the port's kernels.

Each function here is the contract its CUDA kernel in ``csrc/`` must meet,
and the version a wrapper in ``ops`` takes for a tensor on the CPU.  They
copy the contracts of the JAX package's ``kernels/ref.py``:

  ``l2_distances_ref``           [Q, d] x [N, d] squared L2 in the norm
                                 identity form, clamped at 0;
  ``adc_distances_ref``          ``out[n] = sum_m lut[m, codes[n, m]]``;
  ``frontier_select{,_batch}_ref``  one beam-search round step;
  ``robust_prune_fp_ref``        R rounds of Algorithm 3, full precision;
  ``robust_prune_sdc_ref``       the same rounds, cover from PQ codes (SDC);
  ``delete_repair_{fp,sdc}_ref`` Algorithm 4 for a block of nodes:
                                 candidate assembly
                                 (``delete_repair_assemble_ref``), the prune
                                 rounds, the changed-row select;
  ``gather_rows_ref``            the row gather ``table[ids]`` with INVALID
                                 rows for ids < 0 (``hbm_gather_rows``);
  ``block_topk_ref``             the stable smallest-k of each row with
                                 its ids (``block_topk``), following the
                                 Pallas kernel, not the JAX ``ref``.

All of them are batched over a leading row axis [B, ...] (the JAX
contracts are per row and vmapped).  ``l2_rows_ref`` and ``adc_rows_ref``
are the gather-fused forms the Hopper kernels compute (the engine gathered
rows before the TPU kernels ran); ``repair_operands_{fp,sdc}`` do the
gathers of the JAX package's repair engine, turning (adjacency, flags,
table, node ids) -- what the fused ``delete_repair`` kernels take -- into
the operands of the two repair contracts.
"""
from __future__ import annotations

import torch

INVALID = -1


def l2_distances_ref(queries: torch.Tensor, points: torch.Tensor
                     ) -> torch.Tensor:
    """[Q, d] x [N, d] -> [Q, N] squared L2 (f32, norm identity, >= 0)."""
    q = queries.float()
    x = points.float()
    qn = (q * q).sum(-1, keepdim=True)
    xn = (x * x).sum(-1)
    return torch.clamp(qn - 2.0 * (q @ x.T) + xn[None, :], min=0.0)


def l2_rows_ref(queries: torch.Tensor, table: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """q [B, d], table [N, d], ids [B, K] -> [B, K]: the norm-identity
    distance from ``q[b]`` to ``table[ids[b, k]]``; ids < 0 -> +inf."""
    q = queries.float()
    x = table[ids.clamp(min=0).long()].float()              # [B, K, d]
    qn = (q * q).sum(-1, keepdim=True)                       # [B, 1]
    xn = (x * x).sum(-1)                                     # [B, K]
    qx = torch.bmm(x, q[:, :, None])[:, :, 0]                # [B, K]
    d = torch.clamp(qn - 2.0 * qx + xn, min=0.0)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor
                    ) -> torch.Tensor:
    """table [N, R], ids [..., W] -> [..., W, R]: ``table[ids]``, INVALID
    rows where ids < 0 (an id >= N raises ``IndexError`` on the CPU)."""
    r = table[ids.clamp(min=0).long()]
    return torch.where((ids >= 0)[..., None], r, torch.full_like(r, INVALID))


def adc_distances_ref(codes: torch.Tensor, lut: torch.Tensor
                      ) -> torch.Tensor:
    """codes [N, m] uint8/int, lut [m, ksub] f32 -> [N] f32."""
    m = lut.shape[0]
    ar = torch.arange(m, device=lut.device)
    return lut[ar[None, :], codes.long()].sum(-1).float()


def adc_rows_ref(luts: torch.Tensor, codes: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """luts [B, m, ksub], codes [N, m] uint8, ids [B, K] -> [B, K]:
    ``sum_m luts[b, m, codes[ids[b, k], m]]``; ids < 0 -> +inf."""
    B, m, ksub = luts.shape
    K = ids.shape[1]
    c = codes[ids.clamp(min=0).long()].long()                # [B, K, m]
    flat = c + (torch.arange(m, device=luts.device) * ksub)[None, None, :]
    g = torch.gather(luts.reshape(B, m * ksub).float(), 1,
                     flat.reshape(B, K * m)).reshape(B, K, m)
    d = g.sum(-1)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def frontier_select_batch_ref(cand_ids, cand_d, new_ids, new_d, vis_ids,
                              vis_d, vis_cnt, *, W: int,
                              max_visits: int | None = None):
    """One fused beam-search round step for every query row.

    Rows: ``cand_ids/cand_d`` [B, L] (sorted), ``new_ids/new_d`` [B, K],
    ``vis_ids/vis_d`` [B, V], ``vis_cnt`` [B] int32.  Merges the fresh
    neighbors into the candidate list (stable top-L over the [L + K]
    concatenation), marks merged entries that are valid, finite and not
    visited as open, takes the first ``min(W, max_visits - vis_cnt)`` open
    entries as the next frontier and appends it to the visited arrays.
    Returns ``(m_ids, m_d, f_ids, f_d, vis_ids', vis_d', vis_cnt')``.
    """
    B, L = cand_ids.shape
    V = vis_ids.shape[1]
    if max_visits is None:
        max_visits = V
    dev = cand_ids.device
    all_ids = torch.cat([cand_ids, new_ids], 1)
    all_d = torch.cat([cand_d, new_d], 1).float()
    order = torch.sort(all_d, dim=1, stable=True).indices[:, :L]
    m_ids = all_ids.gather(1, order)
    m_d = all_d.gather(1, order)
    fin = torch.isfinite(m_d)
    m_ids = torch.where(fin, m_ids, torch.full_like(m_ids, INVALID))

    in_vis = (m_ids[:, :, None] == vis_ids[:, None, :]).any(2)
    open_ = (m_ids >= 0) & fin & ~in_vis
    allowed = torch.clamp(max_visits - vis_cnt.long(), max=W)   # [B]
    rank = torch.cumsum(open_.long(), 1) - 1
    take = open_ & (rank < allowed[:, None])
    n_take = take.sum(1)

    fpos = torch.sort((~take).to(torch.int8), dim=1,
                      stable=True).indices[:, :W]
    fvalid = take.gather(1, fpos)
    f_ids = torch.where(fvalid, m_ids.gather(1, fpos),
                        torch.full_like(fpos, INVALID, dtype=m_ids.dtype))
    f_d = torch.where(fvalid, m_d.gather(1, fpos),
                      torch.full_like(fpos, float("inf"), dtype=m_d.dtype))

    # Append at vis_cnt.. ; positions past V are dropped (written to a
    # scratch column that is sliced off, so no index is ever duplicated
    # among the kept columns).
    wpos = vis_cnt.long()[:, None] + torch.arange(W, device=dev)[None, :]
    wpos = torch.where(fvalid & (wpos < V), wpos, torch.full_like(wpos, V))
    vi = torch.cat([vis_ids, vis_ids.new_full((B, 1), INVALID)], 1)
    vd = torch.cat([vis_d.float(), vis_d.new_full((B, 1), float("inf"))], 1)
    vi = vi.scatter(1, wpos, f_ids)[:, :V]
    vd = vd.scatter(1, wpos, f_d)[:, :V]
    return (m_ids, m_d, f_ids, f_d, vi, vd,
            (vis_cnt + n_take).to(vis_cnt.dtype))


def frontier_select_ref(cand_ids, cand_d, new_ids, new_d, vis_ids, vis_d,
                        vis_cnt, *, W: int, max_visits: int | None = None):
    """``frontier_select_batch_ref`` for a single query row (1-D inputs,
    scalar ``vis_cnt``)."""
    out = frontier_select_batch_ref(
        cand_ids[None], cand_d[None], new_ids[None], new_d[None],
        vis_ids[None], vis_d[None], torch.as_tensor(vis_cnt).reshape(1),
        W=W, max_visits=max_visits)
    return tuple(x[0] for x in out)


def _prune_rounds(d_p: torch.Tensor, ids: torch.Tensor, ok: torch.Tensor,
                  cover, *, alpha: float, R: int):
    """Exactly R RobustPrune rounds over [B, C] rows: the alive candidate
    with the least anchor distance wins (lowest column on ties), its id is
    emitted, and every candidate it alpha-covers (``alpha * cover(star)[c]
    <= d_p[c]``) retires; a round without a finite winner retires the row.
    ``cover(star)`` maps the winners' columns [B] to [B, C] distances.
    Returns (out_ids [B, R] INVALID-padded, counts [B] int32)."""
    B, C = ids.shape
    dev = ids.device
    inf = torch.tensor(float("inf"), device=dev)
    dp = torch.where(ok, d_p.float(), inf)
    alive = ok & torch.isfinite(dp)
    out = torch.full((B, R), INVALID, dtype=torch.int32, device=dev)
    cnt = torch.zeros(B, dtype=torch.int32, device=dev)
    cols = torch.arange(C, device=dev)[None, :]
    rows = torch.arange(B, device=dev)
    for i in range(R):
        masked = torch.where(alive, dp, inf)
        star = torch.argmin(masked, dim=1)                  # first minimum
        okr = torch.isfinite(masked[rows, star])
        out[:, i] = torch.where(okr, ids[rows, star].int(),
                                torch.full_like(star, INVALID).int())
        cnt += okr.int()
        covered = alpha * cover(star) <= dp
        alive = alive & ~covered & (cols != star[:, None]) & okr[:, None]
    return out, cnt


def robust_prune_fp_ref(d_p: torch.Tensor, vecs: torch.Tensor,
                        ids: torch.Tensor, ok: torch.Tensor, *,
                        alpha: float, R: int):
    """RobustPrune (Algorithm 3) rounds over a block of candidate rows.

    d_p [B, C] raw anchor distances, vecs [B, C, d], ids [B, C] int32,
    ok [B, C] bool.  Cover distances ``|v* - v_c|^2`` in the elementwise
    form.  Returns (out_ids [B, R] INVALID-padded, counts [B] int32).
    """
    vecs = vecs.float()
    rows = torch.arange(ids.shape[0], device=ids.device)

    def cover(star):
        diff = vecs[rows, star][:, None, :] - vecs           # [B, C, d]
        return (diff * diff).sum(-1)

    return _prune_rounds(d_p, ids, ok, cover, alpha=alpha, R=R)


def sdc_cover_ref(tables: torch.Tensor, codes: torch.Tensor,
                  star: torch.Tensor) -> torch.Tensor:
    """SDC distances from each row's candidate ``star`` [B] to all its
    candidates: ``sum_m T[m, codes[b, star, m], codes[b, c, m]]`` ->
    [B, C] (tables [m, ksub, ksub], codes [B, C, m] int)."""
    B, C, m = codes.shape
    rows = torch.arange(B, device=codes.device)
    ar = torch.arange(m, device=codes.device)
    lut = tables.float()[ar[None, :], codes[rows, star].long()]  # [B, m, k]
    g = torch.gather(lut, 2, codes.long().permute(0, 2, 1))      # [B, m, C]
    return g.sum(1)


def robust_prune_sdc_ref(d_p: torch.Tensor, codes: torch.Tensor,
                         tables: torch.Tensor, ids: torch.Tensor,
                         ok: torch.Tensor, *, alpha: float, R: int):
    """The rounds of ``robust_prune_fp_ref`` with candidate-candidate
    distances from PQ codes: codes [B, C, m] int, tables [m, ksub, ksub]
    (``pq.sdc_tables``).  Returns (out_ids [B, R], counts [B] int32)."""
    return _prune_rounds(d_p, ids, ok,
                         lambda star: sdc_cover_ref(tables, codes, star),
                         alpha=alpha, R=R)


def delete_repair_assemble_ref(row, nbr_del, exp, exp_ok, usable_c, p):
    """Algorithm-4 candidate assembly for a block of nodes.

    row [B, R] out-neighbours, nbr_del [B, R] bool (the neighbour is
    deleted), exp [B, E, R] expansion rows, exp_ok [B, E] bool (the
    expansion parent is a deleted neighbour), usable_c [B, C] bool, the
    usability of the raw ``concat(row, exp)`` candidates, p [B] node ids.
    Returns (cand_ids [B, C], INVALID on masked lanes; ok [B, C]) with
    C = R + E * R: a kept lane is valid when its edge exists and its target
    is not deleted, an expansion lane when its parent is deleted.
    """
    B, R = row.shape
    exp_flat = exp.reshape(B, -1)
    exp_flat_ok = (exp_ok.repeat_interleave(exp.shape[2], dim=1)
                   & (exp_flat >= 0))
    raw = torch.cat([row, exp_flat], 1)
    src_ok = torch.cat([(row >= 0) & ~nbr_del, exp_flat_ok], 1)
    ok = src_ok & usable_c & (raw != p[:, None])
    return torch.where(src_ok, raw, torch.full_like(raw, INVALID)), ok


def _changed(row, nbr_del, live):
    return live & (nbr_del & (row >= 0)).any(1)


def delete_repair_fp_ref(row, nbr_del, exp, exp_ok, usable_c, d_p, vecs, p,
                         live, *, alpha: float, R: int) -> torch.Tensor:
    """One block of Algorithm 4, full precision: assemble the candidates
    (kept live edges + neighbours of deleted neighbours), RobustPrune them
    and emit the new rows [B, R] -- the old row where the node is dead
    (``live`` False) or has no deleted neighbour.  d_p [B, C], vecs
    [B, C, d] and usable_c follow the raw ``concat(row, exp)`` order."""
    cand, ok = delete_repair_assemble_ref(row, nbr_del, exp, exp_ok,
                                          usable_c, p)
    new, _ = robust_prune_fp_ref(d_p, vecs, cand, ok, alpha=alpha, R=R)
    return torch.where(_changed(row, nbr_del, live)[:, None], new, row)


def delete_repair_sdc_ref(row, nbr_del, exp, exp_ok, usable_c, d_p, codes,
                          tables, p, live, *, alpha: float, R: int
                          ) -> torch.Tensor:
    """``delete_repair_fp_ref`` with SDC cover from the candidates' PQ
    codes [B, C, m]."""
    cand, ok = delete_repair_assemble_ref(row, nbr_del, exp, exp_ok,
                                          usable_c, p)
    new, _ = robust_prune_sdc_ref(d_p, codes, tables, cand, ok, alpha=alpha,
                                  R=R)
    return torch.where(_changed(row, nbr_del, live)[:, None], new, row)


def _repair_rows(adjacency, deleted, node_ids):
    rows = adjacency[node_ids.long()]                        # [B, R]
    nbr_del = (rows >= 0) & deleted[rows.clamp(min=0).long()]
    return rows, nbr_del


def first_deleted(nbr_del: torch.Tensor, cap: int):
    """The first ``cap`` deleted columns of each row in column order, as
    ``lax.top_k`` over the 0/1 indicator gives them (then the lowest
    non-deleted columns): (idx [B, cap] int64, take [B, cap] bool)."""
    idx = torch.sort((~nbr_del).to(torch.int8), dim=1,
                     stable=True).indices[:, :cap]
    return idx, nbr_del.gather(1, idx)


def repair_operands_fp(adjacency, deleted, usable, table, node_ids):
    """The JAX repair engine's gathers for ``delete_repair_fp_ref``:
    (row, nbr_del, exp [B, R, R], exp_ok, usable_c, d_p, vecs, p, live),
    d_p in the elementwise L2 form."""
    rows, nbr_del = _repair_rows(adjacency, deleted, node_ids)
    exp = adjacency[rows.clamp(min=0).long()]                # [B, R, R]
    B = rows.shape[0]
    safe_raw = torch.cat([rows, exp.reshape(B, -1)], 1).clamp(min=0).long()
    vecs = table[safe_raw].float()                           # [B, C, d]
    diff = table[node_ids.long()].float()[:, None, :] - vecs
    d_p = (diff * diff).sum(-1)
    return (rows, nbr_del, exp, nbr_del, usable[safe_raw], d_p, vecs,
            node_ids, usable[node_ids.long()])


def repair_operands_sdc(adjacency, deleted, usable, codes, tables, node_ids,
                        cap: int):
    """The JAX repair engine's gathers for ``delete_repair_sdc_ref``
    (expansion capped at the first ``cap`` deleted neighbours):
    (row, nbr_del, exp [B, cap, R], exp_ok, usable_c, d_p, codes [B, C, m],
    tables, p, live), d_p = ``adc(codes[c], sdc_lut(tables, codes[p]))``."""
    rows, nbr_del = _repair_rows(adjacency, deleted, node_ids)
    idx, take = first_deleted(nbr_del, cap)
    dn = rows.gather(1, idx).masked_fill(~take, 0)
    exp = adjacency[dn.long()]                               # [B, cap, R]
    B, m = rows.shape[0], codes.shape[1]
    safe_raw = torch.cat([rows, exp.reshape(B, -1)], 1).clamp(min=0).long()
    cc = codes[safe_raw].long()                              # [B, C, m]
    ar = torch.arange(m, device=codes.device)
    lut = tables.float()[ar[None, :], codes[node_ids.long()].long()]
    d_p = torch.gather(lut, 2, cc.permute(0, 2, 1)).sum(1)   # [B, C]
    return (rows, nbr_del, exp, take, usable[safe_raw], d_p, cc, tables,
            node_ids, usable[node_ids.long()])


def block_topk_ref(dists: torch.Tensor, ids: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """dists [Q, N] f32, ids [N] int32 -> (dists [Q, k] f32, ids [Q, k]
    int32): each row's k smallest distances in ascending order, the lowest
    column first among equal distances (a stable sort on distance), with
    their ids.

    The rules are those of the JAX package's Pallas ``block_topk`` kernel
    (``ops.block_topk``), which differ from its ``ref.block_topk_ref``:

    * a non-finite pick (+inf or -inf) reports id -1, not the real id;
    * k > N pads the row with (+inf, -1);
    * a row holding a NaN returns (NaN, -1) in every column: the kernel's
      row minimum is NaN, ``cd == m`` then matches no column, so every
      round picks the NaN minimum and masks nothing out.

    The kernel writes each round's row minimum, not the picked element;
    only a signed zero could tell the two apart.
    """
    Q, N = dists.shape
    d = dists.float()
    n = min(k, N)
    order = torch.sort(d, dim=1, stable=True).indices[:, :n]
    out_d = torch.full((Q, k), float("inf"), device=d.device)
    out_i = torch.full((Q, k), INVALID, dtype=torch.int32, device=d.device)
    out_d[:, :n] = d.gather(1, order)
    out_i[:, :n] = torch.where(torch.isfinite(out_d[:, :n]),
                               ids.to(torch.int32)[order], INVALID)
    nan = torch.isnan(d).any(1)
    out_d[nan] = float("nan")
    out_i[nan] = INVALID
    return out_d, out_i
