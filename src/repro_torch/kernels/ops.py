"""Wrappers of the nine Hopper kernels.

Each wrapper checks device, dtype, shape and contiguity, then dispatches on
where its tensors lie:

  * on the CPU it returns the plain PyTorch version from ``ref``;
  * on a CUDA device it launches its kernel on the current stream and adds
    one to ``LAUNCHES[name]``, or raises.  There is no fallback: with
    ``use_kernel=False`` a CUDA tensor raises too, because the plain
    versions are references, not the port.

Outputs are allocated here with ``torch.empty``; kernels allocate nothing
and do not synchronise.
"""
from __future__ import annotations

import functools

import torch

from . import ref

LAUNCHES: dict[str, int] = {"l2_rows": 0, "adc_rows": 0,
                            "frontier_select": 0, "robust_prune_fp": 0,
                            "robust_prune_sdc": 0, "delete_repair_fp": 0,
                            "delete_repair_sdc": 0, "gather_rows": 0,
                            "block_topk": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(name: str, tensors, use_kernel: bool) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not use_kernel:
        raise ValueError(f"{name}: use_kernel=False on a CUDA tensor; the "
                         "plain version is a CPU reference only")
    return True


def _check(name: str, t: torch.Tensor, dtype, ndim: int, what: str):
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {what} must be {ndim}-D, got "
                         f"{tuple(t.shape)}")


# Each kernel's bound ctypes entry point, filled on its first launch: later
# launches take one dict lookup (no import, no build lock, no getattr).
_FNS: dict = {}


def _resolve(name: str):
    from .build import library
    return getattr(library(name), name)


def _launch(name: str, *args) -> None:
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = _resolve(name)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of ``t``'s device, read at
    each call (a Python ``torch.cuda.Stream`` is not built for it)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _ptr(t: torch.Tensor) -> int:
    if not t.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    return t.data_ptr()


def l2_rows(queries: torch.Tensor, table: torch.Tensor, ids: torch.Tensor,
            *, use_kernel: bool = True) -> torch.Tensor:
    """q [B, d] f32, table [N, d] f32, ids [B, K] int32 -> [B, K] f32
    squared L2 from ``q[b]`` to ``table[ids[b, k]]`` (norm-identity form,
    clamped at 0); ids < 0 -> +inf."""
    name = "l2_rows"
    _check(name, queries, torch.float32, 2, "queries")
    _check(name, table, torch.float32, 2, "table")
    _check(name, ids, torch.int32, 2, "ids")
    B, d = queries.shape
    if table.shape[1] != d or ids.shape[0] != B:
        raise ValueError(f"{name}: shapes q {tuple(queries.shape)}, table "
                         f"{tuple(table.shape)}, ids {tuple(ids.shape)}")
    if not _on_cuda(name, (queries, table, ids), use_kernel):
        return ref.l2_rows_ref(queries, table, ids)
    K = ids.shape[1]
    out = torch.empty((B, K), dtype=torch.float32, device=queries.device)
    _launch(name, _ptr(queries), _ptr(table), _ptr(ids), _ptr(out), B, K,
            table.shape[0], d, _stream(queries))
    return out


def adc_rows(luts: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor,
             *, use_kernel: bool = True) -> torch.Tensor:
    """luts [B, m, ksub] f32, codes [N, m] uint8, ids [B, K] int32 ->
    [B, K] f32 ``sum_m luts[b, m, codes[ids[b, k], m]]``; ids < 0 -> +inf."""
    name = "adc_rows"
    _check(name, luts, torch.float32, 3, "luts")
    _check(name, codes, torch.uint8, 2, "codes")
    _check(name, ids, torch.int32, 2, "ids")
    B, m, ksub = luts.shape
    if codes.shape[1] != m or ids.shape[0] != B or ksub > 256:
        raise ValueError(f"{name}: shapes luts {tuple(luts.shape)}, codes "
                         f"{tuple(codes.shape)}, ids {tuple(ids.shape)}")
    if not _on_cuda(name, (luts, codes, ids), use_kernel):
        return ref.adc_rows_ref(luts, codes, ids)
    K = ids.shape[1]
    out = torch.empty((B, K), dtype=torch.float32, device=luts.device)
    _launch(name, _ptr(luts), _ptr(codes), _ptr(ids), _ptr(out), B, K,
            codes.shape[0], m, ksub, _stream(luts))
    return out


_FRONTIER_OPERANDS = (
    ("cand_ids", torch.int32, 2), ("cand_d", torch.float32, 2),
    ("new_ids", torch.int32, 2), ("new_d", torch.float32, 2),
    ("vis_ids", torch.int32, 2), ("vis_d", torch.float32, 2),
    ("vis_cnt", torch.int32, 1))
@functools.lru_cache(maxsize=64)
def _frontier_layout(B: int, L: int, W: int, V: int):
    """The seven outputs of ``frontier_select`` as (shape, stride, offset,
    is_float) views of one int32 buffer, each starting 16-byte aligned,
    and the buffer's length."""
    views, off = [], 0
    for cols, is_float in ((L, False), (L, True), (W, False), (W, True),
                           (V, False), (V, True), (None, False)):
        shape, stride = ((B,), (1,)) if cols is None else ((B, cols),
                                                           (cols, 1))
        views.append((shape, stride, off, is_float))
        off += -(-B * (cols or 1) // 4) * 4
    return tuple(views), off


def frontier_select(cand_ids, cand_d, new_ids, new_d, vis_ids, vis_d,
                    vis_cnt, *, W: int, max_visits: int | None = None,
                    use_kernel: bool = True):
    """One beam-search round step for every query row (contract:
    ``ref.frontier_select_batch_ref``).  ids int32, distances f32:
    cand [B, L], new [B, K], vis [B, V], vis_cnt [B] int32 -> (m_ids,
    m_d [B, L], f_ids, f_d [B, W], vis_ids', vis_d' [B, V], vis_cnt' [B]).
    ``vis_cnt`` must equal the number of valid ids in ``vis_ids``.  On the
    card the seven outputs are views of one buffer (one allocation)."""
    name = "frontier_select"
    ins = (cand_ids, cand_d, new_ids, new_d, vis_ids, vis_d, vis_cnt)
    for t, (what, dt, nd) in zip(ins, _FRONTIER_OPERANDS):
        if t.dtype != dt or t.dim() != nd:
            _check(name, t, dt, nd, what)
    B, L = cand_ids.shape
    K = new_ids.shape[1]
    V = vis_ids.shape[1]
    if (cand_d.shape != (B, L) or new_d.shape != (B, K)
            or new_ids.shape[0] != B or vis_ids.shape[0] != B
            or vis_d.shape != (B, V) or vis_cnt.shape != (B,)):
        raise ValueError(f"{name}: mismatched operand shapes")
    if not 1 <= W <= L:
        raise ValueError(f"{name}: need 1 <= W <= L, got W={W}, L={L}")
    if max_visits is None:
        max_visits = V
    if not _on_cuda(name, ins, use_kernel):
        return ref.frontier_select_batch_ref(
            cand_ids, cand_d, new_ids, new_d, vis_ids, vis_d, vis_cnt,
            W=W, max_visits=max_visits)
    views, n = _frontier_layout(B, L, W, V)
    buf = torch.empty(n, dtype=torch.int32, device=cand_ids.device)
    fbuf = buf.view(torch.float32)
    outs = tuple((fbuf if f else buf).as_strided(shape, stride, off)
                 for shape, stride, off, f in views)
    base = buf.data_ptr()
    _launch(name, *(_ptr(t) for t in ins),
            *(base + 4 * off for _, _, off, _ in views),
            B, L, K, V, W, int(max_visits), _stream(cand_ids))
    return outs


def robust_prune_fp(d_p: torch.Tensor, table: torch.Tensor,
                    ids: torch.Tensor, ok: torch.Tensor, *, alpha: float,
                    R: int, use_kernel: bool = True):
    """RobustPrune rounds over a [B, C] block of rows (contract:
    ``ref.robust_prune_fp_ref`` on the candidates' vectors
    ``table[ids]``, ids < 0 read as row 0): d_p [B, C] f32, table [N, d]
    f32 (the kernel gathers the rows), ids [B, C] int32, ok [B, C] bool ->
    (out_ids [B, R] int32 INVALID-padded, counts [B] int32).  An id >= N
    raises on the CPU and is undefined on the card."""
    name = "robust_prune_fp"
    _check(name, d_p, torch.float32, 2, "d_p")
    _check(name, table, torch.float32, 2, "table")
    _check(name, ids, torch.int32, 2, "ids")
    _check(name, ok, torch.bool, 2, "ok")
    B, C = ids.shape
    if d_p.shape != (B, C) or ok.shape != (B, C):
        raise ValueError(f"{name}: mismatched operand shapes")
    if not _on_cuda(name, (d_p, table, ids, ok), use_kernel):
        vecs = table[ids.clamp(min=0).long()]
        return ref.robust_prune_fp_ref(d_p, vecs, ids, ok, alpha=alpha, R=R)
    dev = ids.device
    out = torch.empty((B, R), dtype=torch.int32, device=dev)
    cnt = torch.empty((B,), dtype=torch.int32, device=dev)
    _launch(name, _ptr(d_p), _ptr(table), _ptr(ids), _ptr(ok), _ptr(out),
            _ptr(cnt), B, C, table.shape[1], R, float(alpha), _stream(ids))
    return out, cnt


def _check_tables(name: str, tables: torch.Tensor, m: int) -> None:
    _check(name, tables, torch.float32, 3, "tables")
    if (tables.shape[0] != m or tables.shape[1] != tables.shape[2]
            or tables.shape[1] > 256):
        raise ValueError(f"{name}: tables {tuple(tables.shape)} for m={m} "
                         "(need [m, ksub, ksub], ksub <= 256)")


def robust_prune_sdc(d_p: torch.Tensor, codes: torch.Tensor,
                     tables: torch.Tensor, ids: torch.Tensor,
                     ok: torch.Tensor, *, alpha: float, R: int,
                     use_kernel: bool = True):
    """RobustPrune rounds over a [B, C] block of rows with SDC cover
    (contract: ``ref.robust_prune_sdc_ref`` on the candidates' codes
    ``codes[ids]``): d_p [B, C] f32, codes [N, m] uint8 (the whole code
    table; the kernel gathers the rows), tables [m, ksub, ksub] f32,
    ids [B, C] int32, ok [B, C] bool -> (out_ids [B, R] int32
    INVALID-padded, counts [B] int32)."""
    name = "robust_prune_sdc"
    _check(name, d_p, torch.float32, 2, "d_p")
    _check(name, codes, torch.uint8, 2, "codes")
    _check(name, ids, torch.int32, 2, "ids")
    _check(name, ok, torch.bool, 2, "ok")
    _check_tables(name, tables, codes.shape[1])
    B, C = ids.shape
    if d_p.shape != (B, C) or ok.shape != (B, C):
        raise ValueError(f"{name}: mismatched operand shapes")
    if not _on_cuda(name, (d_p, codes, tables, ids, ok), use_kernel):
        cand = codes[ids.clamp(min=0).long()]
        return ref.robust_prune_sdc_ref(d_p, cand, tables, ids, ok,
                                        alpha=alpha, R=R)
    dev = ids.device
    out = torch.empty((B, R), dtype=torch.int32, device=dev)
    cnt = torch.empty((B,), dtype=torch.int32, device=dev)
    m, ksub = codes.shape[1], tables.shape[1]
    _launch(name, _ptr(d_p), _ptr(codes), _ptr(tables), _ptr(ids), _ptr(ok),
            _ptr(out), _ptr(cnt), B, C, codes.shape[0], m, ksub, R,
            float(alpha), _stream(ids))
    return out, cnt


def _check_repair(name, adjacency, deleted, usable, node_ids, R):
    _check(name, adjacency, torch.int32, 2, "adjacency")
    _check(name, deleted, torch.bool, 1, "deleted")
    _check(name, usable, torch.bool, 1, "usable")
    _check(name, node_ids, torch.int32, 1, "node_ids")
    N = adjacency.shape[0]
    if adjacency.shape[1] != R or deleted.shape != (N,) or (
            usable.shape != (N,)):
        raise ValueError(f"{name}: adjacency {tuple(adjacency.shape)}, "
                         f"deleted {tuple(deleted.shape)}, usable "
                         f"{tuple(usable.shape)} for R={R}")


def delete_repair_fp(adjacency: torch.Tensor, deleted: torch.Tensor,
                     usable: torch.Tensor, table: torch.Tensor,
                     node_ids: torch.Tensor, *, alpha: float, R: int,
                     use_kernel: bool = True) -> torch.Tensor:
    """Algorithm 4 for the nodes ``node_ids`` [B] (ids in [0, N)):
    adjacency [N, R] int32, deleted and usable [N] bool, table [N, d] f32
    (the prune distances' table) -> their new rows [B, R] int32, read from
    ``adjacency`` as it is (the kernel does the gathers; contract:
    ``ref.delete_repair_fp_ref`` on ``ref.repair_operands_fp``)."""
    name = "delete_repair_fp"
    _check_repair(name, adjacency, deleted, usable, node_ids, R)
    _check(name, table, torch.float32, 2, "table")
    if table.shape[0] != adjacency.shape[0]:
        raise ValueError(f"{name}: table {tuple(table.shape)} for "
                         f"{adjacency.shape[0]} slots")
    if not _on_cuda(name, (adjacency, deleted, usable, table, node_ids),
                    use_kernel):
        return ref.delete_repair_fp_ref(
            *ref.repair_operands_fp(adjacency, deleted, usable, table,
                                    node_ids), alpha=alpha, R=R)
    B = node_ids.shape[0]
    out = torch.empty((B, R), dtype=torch.int32, device=adjacency.device)
    _launch(name, _ptr(adjacency), _ptr(deleted), _ptr(usable), _ptr(table),
            _ptr(node_ids), _ptr(out), B, adjacency.shape[0], R,
            table.shape[1], float(alpha), _stream(adjacency))
    return out


def delete_repair_sdc(adjacency: torch.Tensor, deleted: torch.Tensor,
                      usable: torch.Tensor, codes: torch.Tensor,
                      tables: torch.Tensor, node_ids: torch.Tensor, *,
                      alpha: float, R: int, cap: int,
                      use_kernel: bool = True) -> torch.Tensor:
    """``delete_repair_fp`` with SDC distances from the PQ codes
    [N, m] uint8 and tables [m, ksub, ksub] f32, expanding at most the
    first ``cap`` deleted neighbours of each node (contract:
    ``ref.delete_repair_sdc_ref`` on ``ref.repair_operands_sdc``)."""
    name = "delete_repair_sdc"
    _check_repair(name, adjacency, deleted, usable, node_ids, R)
    _check(name, codes, torch.uint8, 2, "codes")
    _check_tables(name, tables, codes.shape[1])
    if codes.shape[0] != adjacency.shape[0] or not 1 <= cap <= R:
        raise ValueError(f"{name}: codes {tuple(codes.shape)}, cap {cap} "
                         f"for {adjacency.shape[0]} slots, R={R}")
    if not _on_cuda(name, (adjacency, deleted, usable, codes, tables,
                           node_ids), use_kernel):
        return ref.delete_repair_sdc_ref(
            *ref.repair_operands_sdc(adjacency, deleted, usable, codes,
                                     tables, node_ids, cap),
            alpha=alpha, R=R)
    B = node_ids.shape[0]
    out = torch.empty((B, R), dtype=torch.int32, device=adjacency.device)
    _launch(name, _ptr(adjacency), _ptr(deleted), _ptr(usable), _ptr(codes),
            _ptr(tables), _ptr(node_ids), _ptr(out), B, adjacency.shape[0],
            R, codes.shape[1], tables.shape[1], int(cap), float(alpha),
            _stream(adjacency))
    return out


def gather_rows(table: torch.Tensor, ids: torch.Tensor, *,
                use_kernel: bool = True) -> torch.Tensor:
    """table [N, R] int32, ids [..., W] int32 -> [..., W, R] int32:
    ``out[..., w, :] = table[ids[..., w]]``, INVALID (-1) rows where
    ``ids < 0`` (contract: ``ref.gather_rows_ref``).  An id >= N raises on
    the CPU and is undefined on the card, as in the reference's Pallas
    gather."""
    name = "gather_rows"
    _check(name, table, torch.int32, 2, "table")
    if ids.dtype != torch.int32 or ids.dim() < 1:
        raise TypeError(f"{name}: ids must be int32 [..., W], got "
                        f"{ids.dtype} {tuple(ids.shape)}")
    if not _on_cuda(name, (table, ids), use_kernel):
        return ref.gather_rows_ref(table, ids)
    R = table.shape[1]
    out = torch.empty((*ids.shape, R), dtype=torch.int32, device=ids.device)
    _launch(name, _ptr(table), _ptr(ids), _ptr(out), ids.numel(), R,
            _stream(ids))
    return out


BLOCK_TOPK_MAX_K = 128


def block_topk(dists: torch.Tensor, ids: torch.Tensor, k: int, *,
               use_kernel: bool = True):
    """dists [Q, N] f32, ids [N] int32 -> (dists [Q, k] f32, ids [Q, k]
    int32): the k smallest of each row, ascending, the lowest column first
    among equal distances; a non-finite pick reports id -1, k > N pads
    with (+inf, -1) and a row holding a NaN gives (NaN, -1) throughout
    (contract: ``ref.block_topk_ref``).  1 <= k <= 128 on either device."""
    name = "block_topk"
    _check(name, dists, torch.float32, 2, "dists")
    _check(name, ids, torch.int32, 1, "ids")
    Q, N = dists.shape
    if ids.shape[0] != N:
        raise ValueError(f"{name}: ids {tuple(ids.shape)} for {N} columns")
    if not 1 <= k <= BLOCK_TOPK_MAX_K:
        raise ValueError(f"{name}: k={k} outside [1, {BLOCK_TOPK_MAX_K}]")
    if not _on_cuda(name, (dists, ids), use_kernel):
        return ref.block_topk_ref(dists, ids, k)
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dists.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dists.device)
    if Q == 0:
        return out_d, out_i
    _launch(name, _ptr(dists), _ptr(ids), _ptr(out_d), _ptr(out_i), Q, N, k,
            _stream(dists))
    return out_d, out_i
