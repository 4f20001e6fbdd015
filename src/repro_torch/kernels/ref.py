"""Plain PyTorch versions of the four kernels of the main path.

Each function here is the contract its CUDA kernel in ``csrc/`` must meet,
and the version a wrapper in ``ops`` takes for a tensor on the CPU.  They
copy the contracts of the JAX package's ``kernels/ref.py``:

  ``l2_distances_ref``           [Q, d] x [N, d] squared L2 in the norm
                                 identity form, clamped at 0;
  ``adc_distances_ref``          ``out[n] = sum_m lut[m, codes[n, m]]``;
  ``frontier_select{,_batch}_ref``  one beam-search round step;
  ``robust_prune_fp_ref``        R rounds of Algorithm 3, full precision.

``l2_rows_ref`` and ``adc_rows_ref`` are the gather-fused forms the Hopper
kernels compute (the engine gathered rows before the TPU kernels ran).
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


def robust_prune_fp_ref(d_p: torch.Tensor, vecs: torch.Tensor,
                        ids: torch.Tensor, ok: torch.Tensor, *,
                        alpha: float, R: int):
    """RobustPrune (Algorithm 3) rounds over a block of candidate rows.

    d_p [B, C] raw anchor distances, vecs [B, C, d], ids [B, C] int32,
    ok [B, C] bool.  Exactly R rounds: the alive candidate with the least
    distance wins (lowest column on ties), its id is emitted, and every
    candidate it alpha-covers (``alpha * d(star, c) <= d(p, c)``) retires.
    Returns (out_ids [B, R] INVALID-padded, counts [B] int32).
    """
    B, C = ids.shape
    dev = ids.device
    vecs = vecs.float()
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
        diff = vecs[rows, star][:, None, :] - vecs           # [B, C, d]
        d_star = (diff * diff).sum(-1)
        covered = alpha * d_star <= dp
        alive = alive & ~covered & (cols != star[:, None]) & okr[:, None]
    return out, cnt
