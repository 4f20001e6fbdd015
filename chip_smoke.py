"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--n N] [--centres C] [--phases P]
                          [--src DIR]

Phases:

  build    compile the nine CUDA kernels of ``src/repro_torch/kernels/csrc``
           with nvcc into ``build/`` (one nvcc per source, all at once) and
           print each kernel's registers, stack frame and spills (ptxas);
  kernels  run each kernel against its plain PyTorch version on the card at
           the main path's shapes, on integer-valued inputs (must be equal)
           and Gaussian ones (stated tolerance), and time kernel (CUDA
           events, host us per call, torch.profiler device ms), plain
           version and, where one PyTorch call computes the same function,
           that call (``adc_rows`` at B 1024 x K 256, B 256 and K 512;
           ``frontier_select`` also on unsorted candidate lists and at the
           filtered searches' L 150 x V 241 and L 512 x V 784, past the
           256 visited ids it holds in registers; ``robust_prune_fp``
           also at C 640, its tiled path; ``gather_rows``' host path
           broken down by part; the two delete-repair kernels and
           ``gather_rows`` are held against their plain versions after
           the main path, on its merged graph, the repairs on a block of
           affected nodes and on a block of consecutive slots;
           ``block_topk`` at the
           cross-shard merge's shapes, with ties, +-inf and a NaN row);
  parity   small labelled systems on the CPU (plain versions) and on the
           card (kernels) from integer data, through threshold merges
           (local and global Delete phases, arrival and locality order),
           ``consolidate(mode="global")`` and an SDC ``streaming_merge``:
           results, filtered ones and label tables included, must be
           equal; and a small system with ``storage_dir``,
           ``wal_dir`` and ``snapshot_dir`` whose ``search_disk`` results
           and IO counters (cache off) must be equal on both, then crashed
           and recovered on the card, where it must twin the live system;
           and ``train_pq`` at the bootstrap's shape: equal bits from two
           trainings on the card, equal initial centroids on CPU and card;
  recsys   the recsys family at full width (src/repro_torch/configs):
           FM, DeepFM and xDeepFM click scoring through
           ``make_recsys_serve_step`` and SASRec user embeddings, at
           serve_p99 (B 512) and serve_bulk (B 262,144), each held against
           the same weights on the CPU (first 512 rows), rows/s and p50;
           ``make_retrieval_step`` at retrieval_cand (1 x 1,048,576, k
           100) for FM and SASRec; then SASRec retrieval through the
           port's streaming FreshDiskANN (262,144 normalized items
           bootstrapped at d 50, PQ m 25, 1 % retired, 17,408 inserted
           through a threshold merge, 4 x 1024 user-embedding queries):
           no retired item, self-hit, recall against exact scoring, and
           ``l2_rows`` (d 50), ``adc_rows`` (m 25) and ``robust_prune_fp``
           (d 50) against their plain versions and timed (added to their
           records' ``by_shape``);
  main     bootstrap_system (points labelled with the selectivity ladder
           of tests/test_filtered.py and 4 tenants) -> 1 % deletes ->
           labelled streaming inserts with RW->RO
           rollover up to a threshold StreamingMerge -> search_batch ->
           another 1 % deletes and a global ``consolidate`` -> an SDC
           ``streaming_merge`` at the freshdiskann-1b per-chip shape, with
           launch counts (those of ``adc_rows``, ``robust_prune_sdc``
           and ``delete_repair_sdc`` also by shape and sweep), recall
           against brute force, self-hits, merge phase times and no
           deleted id returned.
  filtered on the main path's merged system: a filter every point matches
           equals the unfiltered call (ids, dists, hops, cmps); the
           ladder's selectivities 0.5, 0.1 and 0.01 (k and L widened to
           L 100, 150, 512), tenants 0-3 and a tenant with a label, each
           4 x 1024 queries: 5-recall@5 against brute force over the
           matching live points, no id failing its predicate, queries/s
           and p50; ``batch_fanout=False`` and ``shard_lti=4`` filtered
           equal to the fan-out; ``frontier_select``'s launches by shape.
  storage  on the main path's merged LTI: a system with ``storage_dir``,
           ``wal_dir`` and ``snapshot_dir`` writes the layout, serves
           4 x 1024 queries through ``search_disk`` (recall, no deleted id,
           equal to ``search_batch``, IO conservation), beam-searches 1024
           queries through ``HBMSource`` (the ``gather_rows`` kernel) equal
           to ``DenseSource``, streams inserts and deletes through a
           threshold merge that delta-patches the layout and snapshots
           before truncating the WAL, then "crashes" and recovers a fresh
           system that must twin the live one.  Its inserts are labelled
           (op-2 WAL records): filtered ``search_disk`` must equal filtered
           ``search_batch``, the patched layout's label tables the LTI's,
           and the recovered label map the live one's.
  serving  on the main path's merged system: ``shard_lti`` and the sharded
           serving step over 4 shards on the card (equal to the unsharded
           program, counters included), the sequential per-tier oracle,
           the beam-width autotuner, a wall-clock ``BatchScheduler`` in
           front of a ``ReplicaSet``, a scheduler with ``tenant_quota``
           (a tenant's burst shed past its quota, mixed-spec tickets equal
           to ``search_batch`` under their specs), ``ReplicaSet`` under a
           filter, the freshdiskann-1b shard deployment
           (``launch.ann_steps``: 4 sub-indices, distributed search with
           the ``block_topk`` merge and at k 129 with a stable sort, insert
           and merge; recall against brute force) and ``launch.serve`` at
           its defaults on the card and on the CPU (recall within 0.01).
  profile  (only when named) torch.profiler over one search micro-batch,
           one flush and one merge after the main path: device busy share
           and kernel time by name.
  launch   (only when named) the launch path of the nine kernels at the
           main path's shapes on random inputs: event ms, host us per call
           and profiler device ms, beside ``torch.index_select`` and
           ``torch.topk``.  With ``--src DIR`` the port is imported from DIR
           (e.g. a parent tree unpacked with ``git archive``), so
           ``--src DIR --phases build,launch`` times that tree's launch path
           on the same card.

P (the phases) defaults to build,kernels,parity,recsys,main,filtered,
storage,serving.
Prints diagnostics, then the card's name and power limit, then one JSON
line of kernel records, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, with no result line, if any phase fails or there is no card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

KERNEL_META = {
    "l2_rows": ("src/repro_torch/kernels/csrc/l2_rows.cu",
                "src/repro/kernels/l2_distance.py:50"),
    "adc_rows": ("src/repro_torch/kernels/csrc/adc_rows.cu",
                 "src/repro/kernels/pq_adc.py:50"),
    "frontier_select": ("src/repro_torch/kernels/csrc/frontier_select.cu",
                        "src/repro/kernels/frontier_select.py:112"),
    "robust_prune_fp": ("src/repro_torch/kernels/csrc/robust_prune_fp.cu",
                        "src/repro/kernels/robust_prune.py:150"),
    "robust_prune_sdc": ("src/repro_torch/kernels/csrc/robust_prune_sdc.cu",
                         "src/repro/kernels/robust_prune.py:168"),
    "delete_repair_fp": ("src/repro_torch/kernels/csrc/delete_repair_fp.cu",
                         "src/repro/kernels/delete_repair.py:92"),
    "delete_repair_sdc": (
        "src/repro_torch/kernels/csrc/delete_repair_sdc.cu",
        "src/repro/kernels/delete_repair.py:113"),
    "gather_rows": ("src/repro_torch/kernels/csrc/gather_rows.cu",
                    "src/repro/storage/prefetch.py:179"),
    "block_topk": ("src/repro_torch/kernels/csrc/block_topk.cu",
                   "src/repro/kernels/block_topk.py:77"),
}
# The kernels the main path runs; gather_rows runs on the storage and
# serving paths, block_topk on the serving path.
MAIN_KERNELS = tuple(k for k in KERNEL_META
                     if k not in ("gather_rows", "block_topk"))
# The serving phase: the sharded lane (gather_rows, adc_rows, l2_rows,
# frontier_select), the shard builds and inserts (robust_prune_fp), the
# merges' global Delete phases (delete_repair_fp) and the cross-shard merge.
SERVING_KERNELS = ("l2_rows", "adc_rows", "frontier_select",
                   "robust_prune_fp", "delete_repair_fp", "gather_rows",
                   "block_topk")
BUILD = ROOT / "build"
IO_FIELDS = ("io_rows_read", "io_cache_hits", "io_prefetch_hits",
             "io_bytes_read", "storage_rows_patched",
             "storage_blocks_patched", "storage_bytes_written")


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls (CUDA
    events around the whole run, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def host_us(fn, calls: int = 1000, group: int = 100) -> float:
    """Host microseconds per call of ``fn()``: ``time.perf_counter`` around
    ``calls`` calls in groups of ``group``, with no synchronisation inside
    a group (a sync between groups, untimed, keeps the launch queue from
    filling, so a slow kernel does not set the host's pace)."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // group):
        t0 = time.perf_counter()
        for _ in range(group):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (calls // group * group) * 1e6


def device_ms(fn, iters: int = 20, tries: int = 3,
              pad_s: float = 0.05) -> float | None:
    """Device milliseconds per call of ``fn()`` from torch.profiler over a
    window of ``iters`` calls: each device activity's (kernel, copy, fill)
    mean duration, by name, summed over the names -- every call timed here
    runs each of its kernels once.  A mean by name, unlike a total over
    ``iters``, is not thrown off when the profiler keeps only some of a
    window's records.  On the card it kept fewer and fewer records the
    longer the process ran (19, then 3, then none of 20 after the main
    path), so the window is padded with ``pad_s`` of idle host time on
    each side and tried up to ``tries`` times.  A window with no record
    gives None ("not measured"): the profiler is a measuring aid here, and
    the kernel's result and its CUDA-event time are checked and kept
    without it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                t, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        if by_name:
            kept = sum(n for _, n in by_name.values())
            if kept < iters * len(by_name):
                log(f"[profile] torch.profiler kept {kept} of "
                    f"{iters * len(by_name)} device records "
                    f"({', '.join(by_name)[:120]})")
            return sum(t / n for t, n in by_name.values()) / 1e3
        log(f"[profile] torch.profiler recorded no device time "
            f"(window {attempt + 1} of {tries})")
    return None


def _fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def launch_times(fn) -> dict:
    """The three times of one launch path: CUDA-event ms (``time_ms``),
    host µs per call and profiler device ms."""
    return dict(ms=time_ms(fn), host_us=host_us(fn), device_ms=device_ms(fn))


def _fmt_times(t: dict) -> str:
    return (f"{t['ms']:.4f} ms (device {_fmt_ms(t['device_ms'])}, host "
            f"{t['host_us']:.1f} us/call)")


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = n_flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def kernel_record(name, *, err, times, plain_ms, nbytes, nflops,
                  library_ms, shape) -> dict:
    """One entry of the ``kernels`` JSON line (``launches`` is filled in
    from the main path's counts); ``times`` from ``launch_times``."""
    b, by = bound_ms(nbytes, nflops)
    return dict(name=name, route="cuda", source=KERNEL_META[name][0],
                replaces=KERNEL_META[name][1], launches=0,
                max_abs_err=float(err), ms=times["ms"],
                device_ms=times["device_ms"], host_us=times["host_us"],
                plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=library_ms, shape=shape)


# --------------------------------------------------------------- phase 1
def ptxas_report(text: str) -> list[str]:
    """Each kernel's line of an ``nvcc -Xptxas=-v`` log: its (demangled)
    name, registers, stack frame and spill bytes."""
    import re
    props, regs, order, cur, props_of = {}, {}, [], None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            order.append(cur)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props_of = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props_of:
            props[props_of] = m.groups()
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs[cur] = m.group(1)
    names = dict(zip(order, order))
    if shutil.which("c++filt") and order:
        out = subprocess.run(["c++filt"], input="\n".join(order), text=True,
                             capture_output=True).stdout.splitlines()
        if len(out) == len(order):
            names = {f: re.sub(r"^void |\(anonymous namespace\)::", "",
                               n).split("(")[0] for f, n in zip(order, out)}
    lines = []
    for f in order:
        stack, st, ld = props.get(f, ("?", "?", "?"))
        lines.append(f"{names[f]}: {regs.get(f, '?')} registers, {stack} "
                     f"bytes stack frame, {st} bytes spill stores, {ld} "
                     f"bytes spill loads")
    return lines


def phase_build() -> float:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    secs = time.perf_counter() - t0
    for name in build.SIGNATURES:
        build.library(name)
    log(f"[build] nvcc -> {build.BUILD_DIR}: {secs:.2f} s "
        f"(per source {json.dumps({k: round(v, 2) for k, v in build.build_seconds.items()})})")
    for name, text in getattr(build, "build_logs", {}).items():
        for line in ptxas_report(text):
            log(f"[build] ptxas {name}: {line}")
    return secs


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phase 2
def _frontier_inputs(g, B, L, K, V, W, integer: bool, dev,
                     shuffled: bool = False, vis_extra: int = 0):
    """Engine-consistent frontier_select rows: a sorted candidate list with
    an INVALID tail, fresh neighbours with masked lanes, a visited set
    drawn from the candidates with vis_cnt == occupancy.  ``integer``
    draws distances from a few small integers, so ties are everywhere;
    ``shuffled`` puts each candidate list in a random order (the contract
    does not need it sorted); ``vis_extra`` adds up to that many visited
    ids that have left the list (a long search's visited set)."""
    import torch
    rows = []
    for _ in range(4):                      # 4 templates tiled over B rows
        ncand = int(g.integers(1, L + 1))
        nnew = int(g.integers(0, K + 1))
        pool = g.permutation(1 << 20)[:ncand + nnew + vis_extra].astype(
            np.int32)
        draw = ((lambda n: g.integers(0, 8, n).astype(np.float32)) if integer
                else (lambda n: g.random(n).astype(np.float32)))
        ci = np.full(L, -1, np.int32)
        cd = np.full(L, np.inf, np.float32)
        ci[:ncand] = pool[:ncand]
        cd[:ncand] = np.sort(draw(ncand))
        ni = np.full(K, -1, np.int32)
        nd = np.full(K, np.inf, np.float32)
        ni[:nnew] = pool[ncand:ncand + nnew]
        nd[:nnew] = draw(nnew)
        vi = np.full(V, -1, np.int32)
        vd = np.full(V, np.inf, np.float32)
        nvis = min(ncand // 2, V - 1)
        taken = g.permutation(ncand)[:nvis]
        vi[:nvis] = ci[taken]
        vd[:nvis] = cd[taken]
        if vis_extra:
            ne = min(vis_extra, V - 1 - nvis)
            vi[nvis:nvis + ne] = pool[ncand + nnew:ncand + nnew + ne]
            vd[nvis:nvis + ne] = draw(ne)
            nvis += ne
        if shuffled:
            perm = g.permutation(L)
            ci, cd = ci[perm], cd[perm]
        rows.append((ci, cd, ni, nd, vi, vd, np.int32(nvis)))
    reps = -(-B // 4)
    cols = [np.stack([r[i] for r in rows] * reps)[:B] for i in range(7)]
    return tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                 for c in cols)


def _prune_inputs(g, table, B, C, integer: bool):
    """(d_p, table, ids, ok) for ``robust_prune_fp``: ids into ``table``
    [N, d] with duplicates within each row, ids < 0 and masked lanes, and
    the exact anchor distances to a random anchor (integer-valued when
    ``integer``, with an integer table, so every sum is exact)."""
    import torch
    dev = table.device
    N, d = table.shape
    ids = g.integers(0, N, (B, C)).astype(np.int32)
    ids[:, C // 2:C // 2 + C // 8] = ids[:, :C // 8]          # duplicates
    ids[g.random((B, C)) < 0.05] = -1
    ids = torch.from_numpy(ids).to(dev)
    ok = (ids >= 0) & torch.from_numpy(g.random((B, C)) > 0.1).to(dev)
    anchor = (g.integers(-3, 4, (B, 1, d)) if integer
              else g.standard_normal((B, 1, d))).astype(np.float32)
    vecs = table[ids.clamp(min=0).long()]
    d_p = ((torch.from_numpy(anchor).to(dev) - vecs) ** 2).sum(-1)
    return d_p, table, ids, ok


def prune_work(d_p, ok, cover, alpha, R) -> int:
    """Candidate-cover evaluations the prune rounds need on these inputs
    (alive candidates summed over the rounds that find a winner);
    ``cover(star)`` gives the winners' [B, C] cover distances."""
    import torch
    inf = torch.tensor(float("inf"), device=d_p.device)
    dp = torch.where(ok, d_p, inf)
    alive = ok & torch.isfinite(dp)
    rows = torch.arange(d_p.shape[0], device=d_p.device)
    cols = torch.arange(d_p.shape[1], device=d_p.device)[None]
    total = 0
    for _ in range(R):
        masked = torch.where(alive, dp, inf)
        star = masked.argmin(1)
        okr = torch.isfinite(masked[rows, star])
        total += int((alive & okr[:, None]).sum())
        cov = alpha * cover(star) <= dp
        alive = alive & ~cov & (cols != star[:, None]) & okr[:, None]
    return total


def prune_fp_bytes(d_p, table, ids, ok, R) -> int:
    """Bytes ``robust_prune_fp`` must move on these inputs: d_p, ids and ok
    of every candidate, one table row for each distinct row that an alive
    candidate (ok, finite d_p) names, and the outputs."""
    import torch
    B, C = ids.shape
    alive = ok & torch.isfinite(d_p)
    n_rows = int(torch.unique(ids[alive].clamp(min=0)).numel())
    return B * C * (4 + 4 + 1) + n_rows * table.shape[1] * 4 + B * (R + 1) * 4


def fp_cover(vecs):
    import torch
    rows = torch.arange(vecs.shape[0], device=vecs.device)

    def cover(star):
        diff = vecs[rows, star][:, None, :] - vecs
        return (diff * diff).sum(-1)
    return cover


def shape_entry(r: dict) -> dict:
    """A ``by_shape`` entry of a kernel record from a reading's dict."""
    b, by = bound_ms(r["nbytes"], r["nflops"])
    return dict(shape=r["shape"], max_abs_err=float(r["err"]),
                plain_ms=r["plain_ms"], bound_ms=b, bound_by=by,
                library_ms=r["library_ms"], **r["times"])


def l2_rows_reading(g, table_int, table, B: int, K: int) -> dict:
    """``l2_rows`` at B x K rows of ``table`` [N, d] (10 % of the ids
    -1): equal to its plain version on the integer table and integer
    queries, within rtol 1e-5 + atol 1e-3 on ``table`` and Gaussian
    queries; kernel, plain version and ``torch.cdist`` over the gathered
    rows timed.  Returns ``kernel_record``'s keyword arguments."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = table.device
    n_table, d = table.shape
    ids_np = g.integers(0, n_table, (B, K)).astype(np.int32)
    ids_np[g.random((B, K)) < 0.1] = -1
    ids = torch.from_numpy(ids_np).to(dev)
    qi = torch.from_numpy(g.integers(-4, 5, (B, d)).astype(np.float32)
                          ).to(dev)
    got = ops.l2_rows(qi, table_int, ids)
    want = ref.l2_rows_ref(qi, table_int, ids)
    check(torch.equal(got, want),
          f"l2_rows K={K} d={d}: integer inputs differ")
    q = torch.from_numpy(g.standard_normal((B, d)).astype(np.float32)
                         ).to(dev)
    got = ops.l2_rows(q, table, ids)
    want = ref.l2_rows_ref(q, table, ids)
    fin = torch.isfinite(want)
    check(torch.equal(fin, torch.isfinite(got)), "l2_rows: inf lanes")
    err = (got[fin] - want[fin]).abs()
    # rtol 1e-5 on the value, atol 1e-3 for the cancellation of
    # |q|^2 + |x|^2 (about 256 at d 128) in the norm identity.
    check(bool((err <= 1e-5 * want[fin].abs() + 1e-3).all()),
          f"l2_rows K={K} d={d}: max err {float(err.max())}")
    t = launch_times(lambda: ops.l2_rows(q, table, ids))
    plain = time_ms(lambda: ref.l2_rows_ref(q, table, ids))
    gathered = table[ids.clamp(min=0).long()]
    lib = time_ms(lambda: torch.cdist(q[:, None, :], gathered))
    nbytes = B * K * d * 4 + B * d * 4 + B * K * 4 * 2
    log(f"[kernels] l2_rows B={B} K={K} d={d}: max_abs_err "
        f"{float(err.max()):.3g}  kernel {_fmt_times(t)}  plain "
        f"{plain:.4f} ms  cdist(gathered) {lib:.4f} ms  bound "
        f"{bound_ms(nbytes, 4.0 * B * K * d)[0]:.4f} ms")
    return dict(err=err.max(), times=t, plain_ms=plain, nbytes=nbytes,
                nflops=4.0 * B * K * d, library_ms=lib,
                shape=f"B={B} K={K} d={d} N={n_table}")


def adc_rows_reading(g, codes, lut_fn, B: int, K: int) -> dict:
    """``adc_rows`` at B x K rows of ``codes`` [N, m] (10 % of the ids
    -1): equal to its plain version on integer LUTs, within rtol 1e-5 +
    atol 1e-6 on real ones (``lut_fn(B)``, or squared Gaussians) and
    timed.  Returns ``kernel_record``'s keyword arguments."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = codes.device
    n_table, m = codes.shape
    ksub = 256
    ids_np = g.integers(0, n_table, (B, K)).astype(np.int32)
    ids_np[g.random((B, K)) < 0.1] = -1
    ids = torch.from_numpy(ids_np).to(dev)
    luts_i = torch.from_numpy(g.integers(0, 50, (B, m, ksub)).astype(
        np.float32)).to(dev)
    check(torch.equal(ops.adc_rows(luts_i, codes, ids),
                      ref.adc_rows_ref(luts_i, codes, ids)),
          f"adc_rows B={B} K={K} m={m}: integer inputs differ")
    luts = (lut_fn(B) if lut_fn else torch.from_numpy(
        (g.standard_normal((B, m, ksub)) ** 2).astype(np.float32)).to(dev))
    got = ops.adc_rows(luts, codes, ids)
    want = ref.adc_rows_ref(luts, codes, ids)
    fin = torch.isfinite(want)
    check(torch.equal(fin, torch.isfinite(got)),
          f"adc_rows B={B} K={K} m={m}: inf lanes")
    err = (got[fin] - want[fin]).abs()
    check(bool((err <= 1e-5 * want[fin].abs() + 1e-6).all()),
          f"adc_rows B={B} K={K} m={m}: max err {float(err.max())}")
    t = launch_times(lambda: ops.adc_rows(luts, codes, ids))
    plain = time_ms(lambda: ref.adc_rows_ref(luts, codes, ids))
    nbytes = B * m * ksub * 4 + B * K * m + B * K * 4 * 2
    bnd = bound_ms(nbytes, float(B * K * m))
    log(f"[kernels] adc_rows B={B} K={K} m={m} ksub={ksub}: max_abs_err "
        f"{float(err.max()):.3g}  kernel {_fmt_times(t)}  plain "
        f"{plain:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]})")
    return dict(err=err.max(), times=t, plain_ms=plain, nbytes=nbytes,
                nflops=float(B * K * m), library_ms=None,
                shape=f"B={B} K={K} m={m} ksub={ksub} N={n_table}")


def prune_fp_reading(g, table_int, table, B: int, C: int, tag: str,
                     alpha: float = 1.2, R: int = 64) -> dict:
    """``robust_prune_fp`` at B x C candidates of ``table`` [N, d]: equal
    to its plain version on the integer table, at most 0.1 % of rows
    differing on ``table`` (cover sums in another order may flip a
    near-tie alpha test), and timed.  Returns ``kernel_record``'s
    keyword arguments."""
    from repro_torch.kernels import ops, ref
    d = table.shape[1]
    a = _prune_inputs(g, table_int, B, C, True)
    go, gc = ops.robust_prune_fp(*a, alpha=alpha, R=R)
    wo, wc = ref.robust_prune_fp_ref(
        a[0], table_int[a[2].clamp(min=0).long()], *a[2:], alpha=alpha, R=R)
    check(go.equal(wo) and gc.equal(wc),
          f"robust_prune_fp {tag} d={d}: integer inputs differ")
    a = _prune_inputs(g, table, B, C, False)
    vecs = table[a[2].clamp(min=0).long()]
    go, gc = ops.robust_prune_fp(*a, alpha=alpha, R=R)
    wo, wc = ref.robust_prune_fp_ref(a[0], vecs, *a[2:], alpha=alpha, R=R)
    n_diff = int((go != wo).any(1).sum())
    check(n_diff <= 0.001 * B, f"robust_prune_fp {tag} d={d}: {n_diff} of "
          f"{B} rows differ")
    t = launch_times(lambda: ops.robust_prune_fp(*a, alpha=alpha, R=R))
    plain = time_ms(lambda: ref.robust_prune_fp_ref(
        a[0], table[a[2].clamp(min=0).long()], *a[2:], alpha=alpha, R=R),
        iters=3)
    work = prune_work(a[0], a[3], fp_cover(vecs), alpha, R)
    nbytes = prune_fp_bytes(*a, R)
    nflops = 3.0 * d * work
    del vecs
    bnd = bound_ms(nbytes, nflops)
    log(f"[kernels] robust_prune_fp {tag} B={B} C={C} d={d} R={R}: "
        f"integer equal, {n_diff} Gaussian rows differ  kernel "
        f"{_fmt_times(t)}  plain {plain:.4f} ms  bound {bnd[0]:.4f} ms "
        f"({bnd[1]})")
    return dict(err=0.0, times=t, plain_ms=plain, nbytes=nbytes,
                nflops=nflops, library_ms=None,
                shape=f"B={B} C={C} d={d} R={R} ({tag})")


def phase_kernels(seed: int, n_table: int) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    g = np.random.default_rng(seed)
    recs = {}

    def record(name, **kw):
        recs[name] = kernel_record(name, **kw)

    # ---- l2_rows: B 1024, K 256 (W*R) and K 100 (rerank), d 128 --------
    d = 128
    table_int = torch.from_numpy(
        g.integers(-4, 5, (n_table, d)).astype(np.float32)).to(dev)
    table = torch.randn(n_table, d, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
    for K in (256, 100):
        r = l2_rows_reading(g, table_int, table, 1024, K)
        if K == 256:
            record("l2_rows", **r)

    # ---- adc_rows: B 1024 x K 256 (search, W 4), B 256 x K 256 (the
    # merges' insert chunks) and B 1024 x K 512 (serving, W 8); m 32,
    # ksub 256 --------------------------------------------------------------
    m, ksub = 32, 256
    codes = torch.from_numpy(g.integers(0, ksub, (n_table, m)).astype(
        np.uint8)).to(dev)
    by_shape = []
    for B, K in ((1024, 256), (256, 256), (1024, 512)):
        r = adc_rows_reading(g, codes, None, B, K)
        if (B, K) == (1024, 256):
            record("adc_rows", **r)
        else:
            by_shape.append(shape_entry(r))
    recs["adc_rows"]["by_shape"] = by_shape
    del codes

    # ---- frontier_select: B 1024, L 100, K 256, V 166, W 4 (the main
    # path), and the filtered searches' L 150 (V 241) and L 512 (V 784: the
    # visited ids past the 256 held in registers) ------------------------
    by_shape = []
    for B, L, K, V, W in ((1024, 100, 256, 166, 4), (1024, 150, 256, 241, 4),
                          (1024, 512, 256, 784, 4)):
        for shuffled in (True, False):
            for integer in (True, False):
                args = _frontier_inputs(
                    g, B, L, K, V, W, integer, dev, shuffled,
                    vis_extra=0 if L == 100 else V - L)
                got = ops.frontier_select(*args, W=W, max_visits=V)
                want = ref.frontier_select_batch_ref(*args, W=W,
                                                     max_visits=V)
                for gt, wt, nm in zip(got, want, ["m_ids", "m_d", "f_ids",
                                                  "f_d", "vis_ids", "vis_d",
                                                  "vis_cnt"]):
                    check(gt.dtype == wt.dtype and torch.equal(gt, wt),
                          f"frontier_select L={L} V={V} ("
                          f"{'integer' if integer else 'uniform'} distances,"
                          f" {'unsorted' if shuffled else 'sorted'} list): "
                          f"{nm} differs")
        t = launch_times(lambda: ops.frontier_select(*args, W=W,
                                                     max_visits=V))
        plain = time_ms(lambda: ref.frontier_select_batch_ref(
            *args, W=W, max_visits=V))
        nbytes = B * ((2 * (L + K) + 2 * V + 1) * 4
                      + (2 * L + 2 * W + 2 * V + 1) * 4)
        bnd = bound_ms(nbytes, 0.0)
        log(f"[kernels] frontier_select B={B} L={L} K={K} V={V} W={W}: "
            f"bit-identical (integer and uniform distances, sorted and "
            f"unsorted lists)  kernel {_fmt_times(t)}  plain {plain:.4f} ms"
            f"  bound {bnd[0]:.4f} ms ({bnd[1]})")
        shape = f"B={B} L={L} K={K} V={V} W={W}"
        if L == 100:
            record("frontier_select", err=0.0, times=t, plain_ms=plain,
                   nbytes=nbytes, nflops=0.0, library_ms=None, shape=shape)
        else:
            by_shape.append(dict(shape=shape, max_abs_err=0.0,
                                 plain_ms=plain, bound_ms=bnd[0],
                                 bound_by=bnd[1], **t))
    recs["frontier_select"]["by_shape"] = by_shape

    # ---- robust_prune_fp: insert (B 256, C 203), Delta (B 1024, C 128),
    # and a C past shared memory (the kernel's tiled path) ---------------
    R, alpha = 64, 1.2
    for B, C, tag in ((256, 203, "insert"), (1024, 128, "back-edge"),
                      (64, 640, "tiled")):
        r = prune_fp_reading(g, table_int, table, B, C, tag)
        if tag == "insert":
            record("robust_prune_fp", **r)
    del table, table_int
    torch.cuda.empty_cache()

    # ---- robust_prune_sdc: insert (B 256, C 203) and Patch (B 256, C 128:
    # the Patch phase's chunks run ~230-300 rows at C = R + d_max = 128)
    from repro_torch.core import pq as pqm
    m, ksub = 32, 256
    codes_tab = torch.from_numpy(g.integers(0, ksub, (n_table, m)).astype(
        np.uint8)).to(dev)
    tabs_int = torch.from_numpy(g.integers(0, 9, (m, ksub, ksub)).astype(
        np.float32)).to(dev)
    cb = pqm.PQCodebook(torch.from_numpy(g.standard_normal(
        (m, ksub, d // m)).astype(np.float32)).to(dev))
    tabs = pqm.sdc_tables(cb).contiguous()
    for B, C, tag in ((256, 203, "insert"), (256, 128, "patch")):
        ids_np = g.integers(0, n_table, (B, C)).astype(np.int32)
        ids_np[:, C // 2:C // 2 + C // 8] = ids_np[:, :C // 8]
        ids_np[g.random((B, C)) < 0.05] = -1
        ids = torch.from_numpy(ids_np).to(dev)
        ok = (ids >= 0) & torch.from_numpy(g.random((B, C)) > 0.1).to(dev)
        cand = codes_tab[ids.clamp(min=0).long()]
        d_int = torch.from_numpy(g.integers(0, 9 * m, (B, C)).astype(
            np.float32)).to(dev)
        go, gc = ops.robust_prune_sdc(d_int, codes_tab, tabs_int, ids, ok,
                                      alpha=alpha, R=R)
        wo, wc = ref.robust_prune_sdc_ref(d_int, cand, tabs_int, ids, ok,
                                          alpha=alpha, R=R)
        check(torch.equal(go, wo) and torch.equal(gc, wc),
              f"robust_prune_sdc {tag}: integer inputs differ")
        # Gaussian: anchor distances are ADC of Gaussian queries' LUTs.
        luts = pqm.lut(cb, torch.from_numpy(g.standard_normal(
            (B, d)).astype(np.float32)).to(dev)).contiguous()
        d_p = ref.adc_rows_ref(luts, codes_tab, ids)
        go, gc = ops.robust_prune_sdc(d_p, codes_tab, tabs, ids, ok,
                                      alpha=alpha, R=R)
        wo, wc = ref.robust_prune_sdc_ref(d_p, cand, tabs, ids, ok,
                                          alpha=alpha, R=R)
        n_diff = int((go != wo).any(1).sum())
        # Cover sums of m terms in another order than the plain version's:
        # a near-tie alpha test may flip a row (reported; at most 1 %).
        check(n_diff <= 0.01 * B, f"robust_prune_sdc {tag}: {n_diff} of {B}"
              " rows differ")
        t = launch_times(lambda: ops.robust_prune_sdc(
            d_p, codes_tab, tabs, ids, ok, alpha=alpha, R=R))
        plain = time_ms(lambda: ref.robust_prune_sdc_ref(
            d_p, codes_tab[ids.clamp(min=0).long()], tabs, ids, ok,
            alpha=alpha, R=R), iters=3)
        work = prune_work(d_p, ok, lambda st: ref.sdc_cover_ref(
            tabs, cand, st), alpha, R)
        n_ok = int(ok.sum())
        nbytes = (B * C * (4 + 4 + 1) + n_ok * m + m * ksub * ksub * 4
                  + B * (R + 1) * 4)
        nflops = float(m * work)
        bnd = bound_ms(nbytes, nflops)
        log(f"[kernels] robust_prune_sdc {tag} B={B} C={C} m={m} ksub={ksub}"
            f" R={R}: integer equal, {n_diff} of {B} Gaussian rows differ  "
            f"kernel {_fmt_times(t)}  plain {plain:.4f} ms  bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
        if tag == "insert":
            record("robust_prune_sdc", err=0.0, times=t, plain_ms=plain,
                   nbytes=nbytes, nflops=nflops, library_ms=None,
                   shape=f"B={B} C={C} m={m} ksub={ksub} R={R} ({tag}); "
                   f"Gaussian rows differing {n_diff}/{B}")
    del codes_tab
    torch.cuda.empty_cache()

    # A CUDA tensor with use_kernel=False raises: no silent plain version.
    x = torch.zeros((2, 4), device=dev)
    try:
        ops.l2_rows(x, x, torch.zeros((2, 1), dtype=torch.int32, device=dev),
                    use_kernel=False)
    except ValueError:
        pass
    else:
        raise PhaseError("use_kernel=False on a CUDA tensor did not raise")
    return recs


def phase_launch(seed: int, n_table: int) -> None:
    """The launch path of the nine kernels at the main path's shapes, on
    random inputs (the repair kernels on a random R-64 graph with 1 %
    deleted), with no main path needed: one ``[launch]`` JSON line per
    call with its ``launch_times``; ``adc_rows`` also at B 256 and at
    K 512, ``delete_repair_sdc`` also on a block of 1024 consecutive slots;
    also ``torch.index_select`` at ``gather_rows``' shape and
    ``torch.topk`` at ``block_topk``'s N 20.
    Uses only calls every tree of the port shares (``robust_prune_fp``
    through its main-path caller ``FullPrecisionPrune.prune_rows``), so
    ``--src`` can compare another checkout's launch path on the same card."""
    import torch
    from repro_torch.core.delete import affected_mask
    from repro_torch.core.prune import FullPrecisionPrune
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    g = np.random.default_rng(seed)
    N, d, R = n_table, 128, 64

    def rows(shape, high):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    table = torch.randn(N, d, generator=gen, device=dev)
    codes = rows((N, 32), 256).to(torch.uint8)
    ids = rows((1024, 256), N)
    q = torch.randn(1024, d, generator=gen, device=dev)
    luts = torch.rand(1024, 32, 256, generator=gen, device=dev)
    fr = _frontier_inputs(g, 1024, 100, 256, 166, 4, False, dev)
    d_p, _, p_ids, ok = _prune_inputs(g, table, 256, 203, False)
    prune = FullPrecisionPrune(table)
    tabs = torch.rand(32, 256, 256, generator=gen, device=dev)
    adj = rows((N, R), N)
    deleted = torch.rand(N, generator=gen, device=dev) < 0.01
    usable = ~deleted
    nodes = affected_mask(adj, deleted, usable).nonzero()[:1024, 0].int()
    block = torch.arange(1024, dtype=torch.int32, device=dev)
    ids512 = rows((1024, 512), N)
    g_ids = torch.from_numpy(g.choice(N, (1024, 4)).astype(np.int32)).to(dev)
    g_ids[torch.from_numpy(g.random((1024, 4)) < 0.1).to(dev)] = -1
    safe = g_ids.clamp(min=0).flatten().long()
    t_d = torch.randn(1024, 20, generator=gen, device=dev)
    t_i = torch.arange(20, dtype=torch.int32, device=dev)
    calls = {
        "l2_rows": lambda: ops.l2_rows(q, table, ids),
        "adc_rows": lambda: ops.adc_rows(luts, codes, ids),
        "adc_rows B=256": lambda: ops.adc_rows(luts[:256], codes, ids[:256]),
        "adc_rows K=512": lambda: ops.adc_rows(luts, codes, ids512),
        "frontier_select": lambda: ops.frontier_select(*fr, W=4,
                                                       max_visits=166),
        "robust_prune_fp": lambda: prune.prune_rows(
            d_p, p_ids, ok, alpha=1.2, R=R, use_kernel=True),
        "robust_prune_sdc": lambda: ops.robust_prune_sdc(
            d_p, codes, tabs, p_ids, ok, alpha=1.2, R=R),
        "delete_repair_fp": lambda: ops.delete_repair_fp(
            adj, deleted, usable, table, nodes, alpha=1.2, R=R),
        "delete_repair_sdc": lambda: ops.delete_repair_sdc(
            adj, deleted, usable, codes, tabs, nodes, alpha=1.2, R=R, cap=8),
        "delete_repair_sdc consecutive": lambda: ops.delete_repair_sdc(
            adj, deleted, usable, codes, tabs, block, alpha=1.2, R=R, cap=8),
        "gather_rows": lambda: ops.gather_rows(adj, g_ids),
        "torch.index_select": lambda: torch.index_select(adj, 0, safe),
        "block_topk": lambda: ops.block_topk(t_d, t_i, 5),
        "torch.topk": lambda: torch.topk(t_d, 5, dim=1, largest=False,
                                         sorted=True),
    }
    for name, fn in calls.items():
        log("[launch] " + json.dumps(dict(name=name, **launch_times(fn))))


# --------------------------------------------------------------- phase 3
def _stream_ops(sys_, new, n0):
    """The parity stream: inserts (label i % 4, tenant i % 3) with
    rollovers and threshold merges, deletes in every tier, a buffered
    delete and an unlabelled re-insert."""
    for i in range(len(new)):
        sys_.insert(n0 + i, new[i], labels=[i % 4], tenant=i % 3)
        if i == 100:
            for e in (3, 17, n0 + 5, n0 + 50, n0 + 99):
                sys_.delete(e)
    sys_.delete(n0 + len(new) - 1)
    sys_.insert(17, new[0] + 1.0)


def _parity_specs():
    from repro_torch.core.graph import FilterSpec
    return (FilterSpec(all_of=(1,)), FilterSpec(tenant=2),
            FilterSpec(all_of=(0,), any_of=(2, 3), tenant=1))


def _filtered_rows(s, qs) -> list:
    return [x for sp in _parity_specs()
            for x in s.search_batch(qs, 12, L=48, filter=sp)]


def _labelled_boot(base, cfg, dev, cent, **kw):
    """The parity bootstrap: slot i labelled i % 4, tenant i % 3."""
    import torch
    from repro_torch.core import pq as pqm
    from repro_torch.core.system import bootstrap_system
    n0 = len(base)
    return bootstrap_system(base, np.arange(n0), cfg, device=dev, batch=32,
                            codebook=pqm.PQCodebook(torch.from_numpy(cent)),
                            labels=[[i % 4] for i in range(n0)],
                            tenants=[i % 3 for i in range(n0)], **kw)


def _parity_system(dev, cfg, base, new, qs, cent) -> list:
    """Everything the parity phase compares, for one device: searches after
    the stream (threshold merges included) and after a global
    ``consolidate``, the LTI's graph and ext-id table, an SDC
    ``streaming_merge`` of the result with a global Delete phase, and
    filtered searches (labels, tenants, both) after the stream and after
    the consolidate with the LTI's label tables."""
    import torch
    from repro_torch.core.merge import streaming_merge
    n0 = len(base)
    s = _labelled_boot(base, cfg, dev, cent)
    _stream_ops(s, new, 1000)
    filtered = _filtered_rows(s, qs)
    out = [*s.search_batch(qs, k=5)]
    check(s.stats.merges >= 2 and s.stats.snapshots >= 4,
          f"parity stream: {s.stats.merges} merges")
    for e in (20, 21, 1010, 1011):
        s.delete(e)
    check(s.consolidate(mode="global") == 4, "parity: consolidate count")
    out += [*s.search_batch(qs, k=5), s.lti_ext_ids.copy(),
            s.lti.graph.adjacency.cpu().numpy(),
            np.array([s.stats.local_repairs, s.stats.global_repairs,
                      s.stats.merge_backedge_targets, s.stats.merges])]
    lti = s.lti
    dmask = np.zeros(lti.graph.capacity, bool)
    dmask[np.arange(0, n0, 13)] = True
    merged, st = streaming_merge(
        lti, torch.from_numpy(new[:40] + 1.0).to(dev),
        torch.ones(40, dtype=torch.bool, device=dev),
        torch.from_numpy(dmask).to(dev), cfg.index, cfg.pq, insert_chunk=16,
        block=64, use_sdc=True, repair_mode="global")
    out += [merged.graph.adjacency.cpu().numpy(), st.slots.cpu().numpy(),
            np.array([st.n_deleted, st.n_inserted, st.n_backedge_pairs,
                      st.n_backedge_targets, st.n_prune_rows])]
    return out + filtered + _filtered_rows(s, qs) + [
        s.lti_labels.bits, s.lti_labels.tenant]


def phase_parity(seed: int) -> None:
    """The same small systems on the CPU (plain versions) and on the card
    (kernels): integer coordinates and an integer PQ codebook make every
    sum exact, so results must be equal.  One system merges with local
    Delete phases in arrival order, the other with global ones in
    locality order."""
    import dataclasses
    from repro_torch.core.config import IndexConfig, PQConfig, SystemConfig
    from repro_torch.kernels import ops
    g = np.random.default_rng(seed + 1)
    d, n0 = 16, 256
    base = g.integers(-3, 4, (n0, d)).astype(np.float32)
    new = g.integers(-3, 4, (200, d)).astype(np.float32)
    qs = g.integers(-3, 4, (37, d)).astype(np.float32)
    cent = g.integers(-3, 4, (4, 16, 4)).astype(np.float32)
    local = SystemConfig(
        index=IndexConfig(capacity=512, dim=d, R=8, L_build=16, L_search=24,
                          alpha=1.2, beam_width=4),
        pq=PQConfig(dim=d, m=4, ksub=16), ro_snapshot_points=32,
        merge_threshold=64, temp_capacity=96, insert_batch=16,
        batch_queries=16, merge_block=64, reach_probe_samples=16,
        filter_words=1)
    ordered = dataclasses.replace(local, locality_order=True,
                                  local_repair_threshold=0.0)
    for name, cfg in (("local repair, arrival order", local),
                      ("global repair, locality order", ordered)):
        out = []
        for dev in ("cpu", "cuda"):
            before = dict(ops.LAUNCHES)
            out.append(_parity_system(dev, cfg, base, new, qs, cent))
            ran = {k: ops.LAUNCHES[k] - before[k] for k in MAIN_KERNELS}
            if dev == "cpu":
                check(not any(ran.values()), f"CPU run launched kernels: {ran}")
            else:
                check(all(ran.values()), f"card run skipped a kernel: {ran}")
        for i, (a, b) in enumerate(zip(*out)):
            check(np.array_equal(a, b),
                  f"parity ({name}): CPU and card differ in output {i}")
        log(f"[parity] {name}, n={n0} d={d}: CPU plain path == card kernels "
            f"(searches of {len(qs)} queries after the stream and after a "
            f"global consolidate, the LTI graph, merge counters "
            f"{out[0][6].tolist()} [local, global repairs, Delta targets, "
            f"merges], an SDC streaming_merge; filtered searches of "
            f"{len(_parity_specs())} specs, k 12, L 48, after the labelled "
            f"stream and after the consolidate, and the LTI's label "
            f"tables)")
    phase_storage_parity(local, base, new, qs, cent)
    pq_checks(seed)


def pq_checks(seed: int, n: int = 65536) -> None:
    """``train_pq`` at the main path's shape (the bootstrap's 65,536-point
    sample, dim 128, m 32 x ksub 256, 12 iterations) on the card: two
    trainings give equal bits; with ``kmeans_iters=0`` the CPU and the card
    start from the same centroids."""
    import dataclasses
    import torch
    from repro_torch.core import pq as pqm
    from repro_torch.core.config import PQConfig
    g = np.random.default_rng(seed + 19)
    x = _mixture(g, (g.standard_normal((4096, 128)) * 2.0).astype(
        np.float32), n)
    cfg = PQConfig(dim=128, m=32, ksub=256)
    xd = torch.from_numpy(x).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = pqm.train_pq(xd, cfg).centroids
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    b = pqm.train_pq(xd, cfg).centroids
    check(torch.equal(a, b), "train_pq on the card: two trainings differ")
    c0 = dataclasses.replace(cfg, kmeans_iters=0)
    check(torch.equal(pqm.train_pq(xd, c0).centroids.cpu(),
                      pqm.train_pq(torch.from_numpy(x), c0).centroids),
          "train_pq: the CPU and the card start from different centroids")
    log(f"[parity] train_pq, {n} x 128, m 32 x ksub 256, "
        f"{cfg.kmeans_iters} iterations: {secs:.2f} s on the card, equal "
        f"bits twice; initial centroids equal on CPU and card")


def _storage_cfg(cfg, root: Path, **kw):
    import dataclasses
    return dataclasses.replace(
        cfg, storage_dir=str(root / "store"), wal_dir=str(root / "wal"),
        snapshot_dir=str(root / "snaps"), **kw)


def phase_storage_parity(cfg, base, new, qs, cent,
                         devs=("cpu", "cuda")) -> None:
    """The parity stream on a system with ``storage_dir``, ``wal_dir`` and
    ``snapshot_dir`` (cache off, prefetch depth 1) on the CPU and the card:
    ``search_disk`` results, the system's IO and patch counters and the
    reader's ``IOStats`` must be equal.  Then the card's system "crashes"
    (storage and WAL closed, kept in memory as the twin) and a fresh one
    recovers from the newest merge snapshot and the WAL suffix: ``size``,
    the DeleteList, the LTI and ``search_batch`` must equal the twin's."""
    import torch
    from repro_torch.core.system import FreshDiskANN
    BUILD.mkdir(exist_ok=True)
    n0 = len(base)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        out, systems = [], {}
        for i, dev in enumerate(devs):
            scfg = _storage_cfg(cfg, Path(tmp) / str(i), adjacency_cache_mb=0,
                                prefetch_depth=1)
            s = _labelled_boot(base, scfg, dev, cent)
            _stream_ops(s, new, 1000)
            ids, d = s.search_disk(qs, k=5)
            reader = s._disk_searcher_get().stats.snapshot()
            out.append([ids, d, np.array([getattr(s.stats, f)
                                          for f in IO_FIELDS]),
                        np.array(list(reader.values()))]
                       + [x for sp in _parity_specs() for x in s.search_disk(
                           qs, 12, L=48, filter=sp)])
            systems[i] = (s, scfg)
        for i, (a, b) in enumerate(zip(*out)):
            check(np.array_equal(a, b), f"storage parity: CPU and card "
                  f"differ in output {i}")
        live, scfg = systems[1]
        check(live.stats.merges >= 2 and out[1][2][4] > 0,
              f"storage parity: {live.stats.merges} merges, "
              f"{out[1][2][4]} rows patched")
        live.close_storage()
        live.wal.close()
        rec = FreshDiskANN(scfg, device=devs[1])
        n_rec = rec.recover()
        check(rec.size == live.size and rec.deleted_ext == live.deleted_ext,
              "storage parity: recovered size or DeleteList differs")
        for f in ("adjacency", "active", "deleted"):
            check(torch.equal(getattr(rec.lti.graph, f),
                              getattr(live.lti.graph, f)),
                  f"storage parity: recovered LTI {f} differs")
        for a, b in zip(rec.search_batch(qs, k=5), live.search_batch(qs, k=5)):
            check(np.array_equal(a, b), "storage parity: the recovered "
                  "system's search differs from the twin's")
        check(all(np.array_equal(a, b) for a, b in zip(
            label_rows(rec), label_rows(live))),
            "storage parity: the recovered label map differs from the "
            "twin's")
        rec.close_storage()
        rec.wal.close()
    log(f"[parity] storage, n={n0} d={base.shape[1]}: search_disk of {len(qs)} "
        f"queries, IO counters {dict(zip(IO_FIELDS, out[0][2].tolist()))} "
        f"and IOStats equal on CPU and card after {live.stats.merges} "
        f"merges, filtered search_disk too; recovery on the card replayed "
        f"{n_rec} records (labelled) and twins the live system, label map "
        f"included")


def reachable(state) -> np.ndarray:
    """bool [capacity]: slots reachable from ``state.start`` over the
    adjacency (breadth-first, on the device)."""
    import torch
    adj = state.adjacency.long()
    seen = torch.zeros(state.capacity, dtype=torch.bool,
                       device=adj.device)
    front = state.start.reshape(1).long()
    seen[front] = True
    while len(front):
        nb = adj[front].reshape(-1)
        nb = torch.unique(nb[nb >= 0])
        nb = nb[~seen[nb]]
        seen[nb] = True
        front = nb
    return seen.cpu().numpy()


def _mixture(g, centers, n):
    which = g.integers(0, len(centers), n)
    return (centers[which] + g.standard_normal(
        (n, centers.shape[1])).astype(np.float32)).astype(np.float32)


def _recall(ids, queries, live_vecs, live_ids, k, dev) -> float:
    """k-recall@k of ``ids`` against brute force over the live points."""
    import torch
    xn = (live_vecs * live_vecs).sum(1)
    gt = []
    for lo in range(0, len(queries), 256):
        q = torch.from_numpy(queries[lo:lo + 256]).to(dev)
        d = xn[None, :] - 2.0 * torch.matmul(q, live_vecs.T)
        gt.append(d.topk(k, dim=1, largest=False).indices.cpu().numpy())
    gt = live_ids[np.concatenate(gt)]
    return float(((ids[:, :, None] == gt[:, None, :]).any(2)).sum(1).mean()
                 / k)


@contextlib.contextmanager
def shape_census():
    """Count the launches of ``adc_rows``, ``robust_prune_sdc`` and
    ``delete_repair_sdc`` by the shape each call site gives them, while
    the block runs: {name: {shape: launches}}.  The wrappers are replaced
    in ``ops`` for the duration (the call sites look them up there at each
    call), and ``core.delete._sweep`` is wrapped to tag each repair block
    with its sweep (global: consecutive slots; local: affected nodes)."""
    from repro_torch.core import delete as delete_mod
    from repro_torch.kernels import ops
    census: dict = {"adc_rows": {}, "robust_prune_sdc": {},
                    "delete_repair_sdc": {}}
    sweep = ["outside a sweep"]
    saved = {n: getattr(ops, n) for n in census}
    saved_sweep = delete_mod._sweep

    def count(name, key):
        census[name][key] = census[name].get(key, 0) + 1

    def adc_rows(luts, codes, ids, **kw):
        count("adc_rows", f"B={luts.shape[0]} K={ids.shape[1]}")
        return saved["adc_rows"](luts, codes, ids, **kw)

    def robust_prune_sdc(d_p, codes, tables, ids, ok, **kw):
        count("robust_prune_sdc", f"B={ids.shape[0]} C={ids.shape[1]}")
        return saved["robust_prune_sdc"](d_p, codes, tables, ids, ok, **kw)

    def delete_repair_sdc(adjacency, deleted, usable, codes, tables,
                          node_ids, **kw):
        count("delete_repair_sdc", f"{sweep[0]} B={node_ids.shape[0]}")
        return saved["delete_repair_sdc"](adjacency, deleted, usable, codes,
                                          tables, node_ids, **kw)

    def _sweep(state, rows_fn, block, mode, usable):
        sweep[0] = f"{mode} sweep"
        try:
            return saved_sweep(state, rows_fn, block, mode, usable)
        finally:
            sweep[0] = "outside a sweep"

    ops.adc_rows, ops.robust_prune_sdc = adc_rows, robust_prune_sdc
    ops.delete_repair_sdc, delete_mod._sweep = delete_repair_sdc, _sweep
    try:
        yield census
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
        delete_mod._sweep = saved_sweep


def _fmt_phases(t: dict) -> str:
    return ", ".join(f"{k} {v:.2f} s" for k, v in t.items())


N_TENANTS = 4


def ladder(i: int) -> list:
    """Point i's labels, the selectivity ladder of tests/test_filtered.py:
    bit 0 on every point, bit 1 on i % 2 == 0, bit 2 on i % 10 == 0, bit 3
    on i % 100 == 0 (its tenant is i % 4)."""
    return [0] + [b for b, m in ((1, 2), (2, 10), (3, 100)) if i % m == 0]


def ladder_match(ext, spec) -> np.ndarray:
    """bool: which points (point i has ext id i) satisfy ``spec`` under the
    ladder and tenants i % 4, computed from the ids alone (independent of
    the system's label tables)."""
    ext = np.asarray(ext)
    has = {0: np.ones(len(ext), bool), 1: ext % 2 == 0, 2: ext % 10 == 0,
           3: ext % 100 == 0}
    m = np.ones(len(ext), bool)
    if spec.tenant is not None:
        m &= ext % N_TENANTS == spec.tenant
    for b in spec.all_of:
        m &= has[b]
    if spec.any_of:
        m &= np.any([has[b] for b in spec.any_of], axis=0)
    return m


def label_rows(s) -> tuple:
    """(ext ids sorted, their tenants, their label words) over every tier
    of ``s`` and its insert buffer's flush, deleted ids left out: the
    label map a recovered system must reproduce, whichever tier holds a
    point."""
    s._flush_inserts()
    tiers = [(s.lti_ext_ids, s.lti_labels)]
    tiers += [(t.ext_ids, t.labels) for t in [s.rw] + list(s.ro)]
    ext = np.concatenate([e[e >= 0] for e, _ in tiers])
    ten = np.concatenate([lb.tenant[e >= 0] for e, lb in tiers])
    bits = np.concatenate([lb.bits[e >= 0] for e, lb in tiers])
    dead = np.fromiter(s.deleted_ext, np.int64, len(s.deleted_ext))
    keep = ~np.isin(ext, dead)
    ext, ten, bits = ext[keep], ten[keep], bits[keep]
    o = np.argsort(ext, kind="stable")
    check(len(np.unique(ext)) == len(ext), "an id lives in two tiers")
    return ext[o], ten[o], bits[o]


def phase_main(seed: int, n: int, centres: int = 4096, dev="cuda",
               capacity: int = 2_097_152, ro_points: int = 4096,
               merge_threshold: int = 16384):
    """The freshdiskann-1b per-chip shape (src/repro/configs/
    freshdiskann_1b.py FULL): capacity 2,097,152, dim 128, R 64, L_build
    75, L_search 100, alpha 1.2, W 4, PQ m 32 x ksub 256, k 5, 1024
    concurrent queries, merge_threshold 16,384, merge_block 1024.

    Bootstrap n points; delete 1 % of them; insert merge_threshold +
    ro_points / 4 points (17,408): four RO snapshots trigger a
    StreamingMerge through ``insert`` itself (its Delete phase local, as
    1 % <= local_repair_threshold), and 1,024 points stay in RW; serve
    4 x 1024 queries; delete another 1 % and ``consolidate`` globally
    (every block); then ``streaming_merge(use_sdc=True)`` with a global
    Delete phase of 1 % more deletes and ro_points new points on the LTI.

    The corpus is a mixture of ``centres`` isotropic Gaussians in 128
    dimensions.  With 256 centres the PQ codebook (256 centroids per
    subspace) spends itself on the centres, codes say almost nothing about
    a point's place inside its cluster, and at ~4096 points per cluster the
    PQ-navigated LTI lane's candidate list misses most true neighbours
    (5-recall@5 0.75 at 1M points; PERF.md).  4096 centres keep ~256
    points per cluster, the scale at which the PQ lane is meant to work.
    ``dev``, ``capacity``, ``ro_points`` and ``merge_threshold`` exist to
    rehearse the path at a small size; the card runs the defaults.
    Returns (launch counts of the whole path, the system, and what the
    storage phase reuses: the mixture's centres, the queries and k)."""
    import torch
    from repro_torch.core.config import IndexConfig, PQConfig, SystemConfig
    from repro_torch.core.lti import search_lti
    from repro_torch.core.merge import streaming_merge
    from repro_torch.core.system import bootstrap_system
    from repro_torch.kernels import ops
    dev = torch.device(dev)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    icfg = IndexConfig(capacity=capacity, dim=128, R=64, L_build=75,
                       L_search=100, alpha=1.2, beam_width=4)
    cfg = SystemConfig(index=icfg, pq=PQConfig(dim=128, m=32, ksub=256),
                       ro_snapshot_points=ro_points,
                       merge_threshold=merge_threshold, temp_capacity=65536,
                       insert_batch=256, batch_queries=1024,
                       merge_block=1024, filter_words=1)
    n_new = merge_threshold + ro_points // 4
    n_q, n_self, k = 4 * 1024, 1024, 5
    g = np.random.default_rng(seed)
    centers = (g.standard_normal((centres, 128)) * 2.0).astype(np.float32)
    t0 = time.perf_counter()
    base = _mixture(g, centers, n)
    new = _mixture(g, centers, n_new)
    qs = _mixture(g, centers, n_q)
    sdc_new = _mixture(g, centers, ro_points)
    perm = g.permutation(n)
    dels, dels2, dels3 = (perm[:n // 100], perm[n // 100:2 * (n // 100)],
                          perm[2 * (n // 100):3 * (n // 100)])
    log(f"[main] data: {n} bootstrap + {n_new} inserts + {n_q} queries, "
        f"dim 128, {centres}-centre Gaussian mixture "
        f"({time.perf_counter() - t0:.1f} s on the host)")

    t0 = time.perf_counter()
    labels = [ladder(i) for i in range(n)]
    tenants = np.arange(n) % N_TENANTS
    t_lab = time.perf_counter() - t0

    ops.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = bootstrap_system(base, np.arange(n), cfg, device=dev, labels=labels,
                         tenants=tenants)
    sync()
    t_build = time.perf_counter() - t0
    del labels
    lb = s.lti_labels
    want = np.zeros(n, np.uint32) | 1
    for b, m in ((1, 2), (2, 10), (3, 100)):
        want[::m] |= np.uint32(1 << b)
    check(np.array_equal(lb.bits[:n, 0], want)
          and np.array_equal(lb.tenant[:n], tenants)
          and not lb.bits[n:].any() and (lb.tenant[n:] == -1).all(),
          "bootstrap label tables differ from the ladder")
    log(f"[main] bootstrap_system: {n} points in {t_build:.1f} s "
        f"({n / t_build:.0f} points/s) into capacity {icfg.capacity}; "
        f"labelled with the ladder (bits 0-3 on 1, 1/2, 1/10, 1/100 of the "
        f"points) and {N_TENANTS} tenants ({t_lab:.1f} s to list the labels "
        f"on the host)")

    for e in dels:
        s.delete(int(e))
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    for i in range(n_new):
        s.insert(n + i, new[i], labels=ladder(n + i),
                 tenant=(n + i) % N_TENANTS)
    s._flush_inserts()
    sync()
    t_ins = time.perf_counter() - t0
    st = s.stats
    fl = st.flush_latency.snapshot()
    log(f"[main] {len(dels)} deletes, then {n_new} labelled inserts in "
        f"{t_ins:.2f} s "
        f"({n_new / t_ins:.0f} inserts/s with the merge, "
        f"{n_new / (t_ins - st.merge_seconds):.0f} without); "
        f"{st.flushes} flushes, p50 {fl['p50'] * 1e3:.1f} ms p99 "
        f"{fl['p99'] * 1e3:.1f} ms; tiers: RW {s.rw.n}, RO "
        f"{[t.n for t in s.ro]}")
    log(f"[main] threshold merge: {st.merges} merge of {merge_threshold} "
        f"staged points in {st.merge_seconds:.2f} s "
        f"({_fmt_phases(st.merge_phase_seconds)}); Delete phase "
        f"{'local' if st.local_repairs else 'global'}; Delta targets "
        f"{st.merge_backedge_targets}, prune rows {st.merge_prune_rows}; "
        f"reach probe unreachable {st.unreachable_frac:.4f}; launches "
        f"{json.dumps({k_: ops.LAUNCHES[k_] - before[k_] for k_ in ops.LAUNCHES})}")
    n_live = int(s.lti.graph.active.sum())
    check(st.merges == 1 and st.local_repairs == 1,
          f"expected one threshold merge with a local Delete phase: "
          f"{st.merges} merges, {st.local_repairs} local")
    check(not s.ro and s.rw.n == n_new - merge_threshold,
          f"tiers after the merge: RO {len(s.ro)}, RW {s.rw.n}")
    check(n_live == n - len(dels) + merge_threshold,
          f"LTI live count {n_live} != {n - len(dels) + merge_threshold}")

    before = dict(ops.LAUNCHES)
    s.search_batch(qs[:1024], k=k)                    # warm-up batch
    log(f"[main] launches per search micro-batch (1024 queries, RW + LTI "
        f"lanes): {json.dumps({k_: ops.LAUNCHES[k_] - before[k_] for k_ in ops.LAUNCHES})}")
    s.stats.search_latency = type(s.stats.search_latency)(seed=1)
    t0 = time.perf_counter()
    ids, dists = s.search_batch(qs, k=k)
    t_q = time.perf_counter() - t0
    lat = s.stats.search_latency.snapshot()
    log(f"[main] search_batch {n_q} queries (batch_queries 1024, k {k}, "
        f"L 100, W 4): {n_q / t_q:.0f} queries/s; per micro-batch p50 "
        f"{lat['p50'] * 1e3:.1f} ms p99 {lat['p99'] * 1e3:.1f} ms "
        f"({lat['n']} batches)")
    check(ids.shape == (n_q, k) and dists.shape == (n_q, k),
          "search_batch shapes")
    check(bool(np.isfinite(dists).all()) and bool((ids >= 0).all()),
          "search_batch returned missing results")
    check(bool((np.diff(dists, axis=1) >= 0).all()), "dists not sorted")
    check(not np.isin(ids, dels).any(), "a deleted id was returned")
    keep = np.setdiff1d(np.arange(n), dels)
    live_ids = np.concatenate([keep, n + np.arange(n_new)])
    live = torch.from_numpy(np.concatenate([base[keep], new])).to(dev)
    recall = _recall(ids, qs, live, live_ids, k, dev)
    log(f"[main] 5-recall@5 {recall:.4f} over {len(live_ids)} live points")
    check(recall >= 0.90, f"recall {recall} < 0.90")

    # Self-hits of merged points, now served by the PQ-navigated LTI lane.
    sel = g.choice(merge_threshold, n_self, replace=False)
    self_ids, _ = s.search_batch(new[sel], k=k)
    hit = (self_ids == (n + sel)[:, None]).any(1)
    reach = reachable(s.lti.graph)
    slots = np.array([s._ext_loc[int(n + i)][1] for i in sel])
    check(all(s._ext_loc[int(n + i)][0] == "lti" for i in sel),
          "a merged point is not in the LTI")
    ok_reach = reach[slots]
    self_reach = float(hit[ok_reach].mean())
    log(f"[main] self-hit of merged points: {float(hit.mean()):.4f} of "
        f"{n_self} in top-5 ({float((self_ids[:, 0] == n + sel).mean()):.4f}"
        f" at rank 1); {int((~ok_reach).sum())} of them unreachable from the"
        f" LTI's start; over the reachable ones {self_reach:.4f}; LTI "
        f"unreachable live points "
        f"{int((s.lti.graph.active.cpu().numpy() & ~reach).sum())}")
    check(self_reach >= 0.98,
          f"self-hit over reachable merged points {self_reach} < 0.98")

    qd = torch.from_numpy(qs[:1024]).to(dev)
    sync()
    t0 = time.perf_counter()
    _, _, hops, _ = search_lti(s.lti, qd, icfg, k=k, L=100)
    sync()
    t_lti = time.perf_counter() - t0
    rounds = int(hops.max())
    log(f"[main] LTI lane alone, 1024 queries: {t_lti * 1e3:.1f} ms, "
        f"{rounds} rounds -> {t_lti * 1e3 / max(rounds, 1):.2f} ms per "
        f"round (mean hops {float(hops.float().mean()):.1f})")

    # Another 1 % of deletes, repaired by the global sweep (every block).
    for e in dels2:
        s.delete(int(e))
    sync()
    t0 = time.perf_counter()
    n_cons = s.consolidate(mode="global")
    sync()
    t_cons = time.perf_counter() - t0
    ids2, _ = s.search_batch(qs[:1024], k=k)
    gone = np.concatenate([dels, dels2])
    check(n_cons == len(dels2), f"consolidate removed {n_cons}")
    check(not np.isin(ids2, gone).any(), "a deleted id was returned")
    log(f"[main] consolidate(mode='global') of {n_cons} deletes over "
        f"{-(-icfg.capacity // cfg.merge_block)} blocks: {t_cons:.2f} s")

    # SDC StreamingMerge on the LTI: ro_points new points, 1 % deletes.
    lti = s.lti
    dmask = np.isin(s.lti_ext_ids, dels3)
    timings: dict = {}
    sync()
    t0 = time.perf_counter()
    merged, mst = streaming_merge(
        lti, torch.from_numpy(sdc_new).to(dev),
        torch.ones(ro_points, dtype=torch.bool, device=dev),
        torch.from_numpy(dmask).to(dev), icfg, cfg.pq,
        insert_chunk=cfg.insert_batch, block=cfg.merge_block, use_sdc=True,
        repair_mode="global", timings=timings)
    sync()
    t_sdc = time.perf_counter() - t0
    mg = merged.graph
    live_mask = mg.active & ~mg.deleted
    m_ids, *_ = search_lti(merged, qd, icfg, k=k, L=100)
    m_ids = m_ids.cpu().numpy()
    live_slots = torch.nonzero(live_mask)[:, 0]
    recall_sdc = _recall(m_ids, qs[:1024], mg.vectors[live_slots],
                         live_slots.cpu().numpy(), k, dev)
    log(f"[main] streaming_merge(use_sdc=True, global) of {ro_points} "
        f"points and {mst.n_deleted} deletes: {t_sdc:.2f} s "
        f"({_fmt_phases(timings)}); cap overflows "
        f"{mst.repair_cap_overflows}, Delta targets "
        f"{mst.n_backedge_targets}, prune rows {mst.n_prune_rows}; "
        f"5-recall@5 of the merged LTI lane {recall_sdc:.4f}")
    check(mst.n_deleted == len(dels3) and mst.n_inserted == ro_points,
          f"SDC merge counts {mst.n_deleted}, {mst.n_inserted}")
    check(recall_sdc >= 0.90, f"recall after the SDC merge {recall_sdc}")
    del merged, mg

    sync()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"[main] launches {json.dumps(launches)}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    check(peak < 80 * 2**30, f"peak memory {peak / 2**30:.1f} GiB")
    check(all(launches[k] > 0 for k in MAIN_KERNELS),
          f"a kernel of the path never launched: {launches}")
    return launches, s, dict(centers=centers, qs=qs, k=k)


# The recsys phase's FreshDiskANN run: its search lanes and inserts (and a
# prune route of its merge: full precision or SDC).
RECSYS_KERNELS = ("l2_rows", "adc_rows", "frontier_select")
RECSYS_FM = ("fm", "deepfm", "xdeepfm")
# The recsys phase's sizes: recsys_cells' batch shapes, retrieval_cand's
# candidates, and the SASRec index (262,144 of the 1,048,576 items
# bootstrapped: a cut of scale for the script's time).
RECSYS_BATCHES = {"serve_p99": 512, "serve_bulk": 262_144}
RECSYS_CANDIDATES = 1_048_576
RECSYS_INDEX = 262_144
RECSYS_CAPACITY = 524_288
RECSYS_RO_POINTS = 4096
RECSYS_MERGE_THRESHOLD = 16_384
RECSYS_QUERIES = 4 * 1024


def run_ms(fn, runs: int = 20, warmup: int = 2) -> list:
    """Milliseconds of each of ``runs`` calls of ``fn()`` after ``warmup``
    calls, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in ev]


def _tolerance(want):
    """The card-vs-CPU bound of each element of ``want``: rtol 1e-4, and an
    atol of 1e-6 times the larger of 1 and the row's largest magnitude."""
    scale = want.abs().reshape(want.shape[0], -1).amax(1).clamp(min=1.0)
    scale = scale.reshape((-1,) + (1,) * (want.dim() - 1))
    return 1e-6 * scale + 1e-4 * want.abs()


def _card_vs_cpu(got, want, what: str) -> float:
    """Card against CPU on the same weights and inputs, to ``_tolerance``
    (f32 products summed in another order; TF32 is off).  An element of
    an f32 sum carries an absolute error on the scale of its terms, not of
    itself: a SASRec hidden-state element of ~0.01 in a row reaching ~5
    differed by 2.1e-6 on the card.  For logits (within 1) the atol is
    1e-6."""
    import torch
    got = got.detach().cpu()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what}: shape {tuple(got.shape)} or non-finite values")
    err = (got - want).abs()
    check(bool((err <= _tolerance(want)).all()),
          f"{what}: card vs CPU max err {float(err.max())} (at |CPU| "
          f"{float(want.flatten()[err.argmax()].abs())})")
    return float(err.max())


def _ids_vs_cpu(got_i, want_i, scores, what: str) -> int:
    """Retrieval ids on the card against the CPU's: equal, except at a
    rank where the two ids' exact scores (``scores``, from the CPU's query)
    lie within 1e-5 relative of each other.  Returns the ids differing."""
    got_i, want_i = got_i.cpu().numpy(), want_i.cpu().numpy()
    diff = got_i != want_i
    rows = np.nonzero(diff)[0]
    a = scores[rows, got_i[diff]]
    b = scores[rows, want_i[diff]]
    check(bool(np.all(np.abs(a - b) <= 1e-5 * np.maximum(np.abs(b), 1e-30))),
          f"{what}: ids differ from the CPU's off near ties")
    return int(diff.sum())


def check_rows(B: int) -> np.ndarray:
    """The 512 rows of a batch of B held against the CPU: the first 256
    and 256 spread evenly over the rest, up to the last row, so that every
    CIN chunk of an xDeepFM serve_bulk batch (6,882 rows) holds some."""
    if B <= 512:
        return np.arange(B)
    return np.concatenate([np.arange(256), np.linspace(
        256, B - 1, 256).round().astype(np.int64)])


def _serve_shapes(name, serve, forward, model, cpu_model, make_input,
                  dev) -> dict:
    """Serve each batch shape on the card, rows/s and p50 ms of 20 runs of
    ``serve``; ``forward`` (logits, or SASRec's user embeddings) on the
    whole batch on the card, its ``check_rows`` against the same weights
    on the CPU."""
    import torch
    out = {}
    for shape, B in RECSYS_BATCHES.items():
        x = make_input(B)
        rows = check_rows(B)
        xd = torch.from_numpy(x).to(dev)
        with torch.no_grad():
            served = serve(model, xd)
            got = forward(model, xd)[torch.from_numpy(rows).to(dev)]
            want = forward(cpu_model, torch.from_numpy(x[rows]))
        check(served.shape[0] == B and bool(torch.isfinite(served).all()),
              f"{name} {shape}: {served.shape[0]} rows or non-finite values")
        err = _card_vs_cpu(got, want, f"{name} {shape}")
        ms = run_ms(lambda: serve(model, xd))
        p50 = float(np.median(ms))
        out[shape] = dict(batch=B, p50_ms=p50, rows_per_s=B / p50 * 1e3,
                          max_err=err)
        log(f"[recsys] {name} {shape} (B {B}): card vs CPU on {len(rows)} "
            f"rows (first 256, the rest spread to row {int(rows[-1])}) max "
            f"err {err:.3g}; p50 {p50:.4f} ms a batch (min {min(ms):.4f}, "
            f"max {max(ms):.4f}), {B / p50 * 1e3:.0f} rows/s")
        if name == "xdeepfm" and shape == "serve_bulk":
            out["cin_seen"] = _cin_seen(cpu_model, x[rows], want)
        del xd, served, got
    return out


def _cin_seen(cpu_model, ids, logits) -> float:
    """The share of checked rows whose CIN term exceeds the card-vs-CPU
    bound of their logit: on those rows the check fails a forward that
    drops the CIN."""
    import torch
    from repro_torch.models import recsys as rec
    with torch.no_grad():
        emb = rec.field_lookup(cpu_model.V, torch.from_numpy(ids),
                               cpu_model.cfg)
        cin = rec._cin_apply(cpu_model.cin, cpu_model.cin_head, emb)
    seen = float((cin.abs() > _tolerance(logits)).double().mean())
    log(f"[recsys] xdeepfm: the CIN adds |{float(cin.abs().median()):.3g}| "
        f"(median; max {float(cin.abs().max()):.3g}) to a checked logit; "
        f"it exceeds the logit's bound on {seen:.4f} of the rows")
    return seen


def _retrieval_cand(name, cfg, model, cpu_model, user, table, query_fn,
                    dev) -> dict:
    """``make_retrieval_step`` at batch 1 x the table's rows, k 100: ids
    against the CPU's, ms a call."""
    import torch
    from repro_torch.serving.steps import make_retrieval_step
    step = make_retrieval_step(cfg, k=100)
    td = table.to(dev)
    ud = torch.from_numpy(user).to(dev)
    got_s, got_i = step(model, ud, td)
    want_s, want_i = step(cpu_model, torch.from_numpy(user), table)
    with torch.no_grad():
        q = query_fn(cpu_model, torch.from_numpy(user)).numpy()
    scores = q.astype(np.float64) @ table.numpy().T.astype(np.float64)
    n_diff = _ids_vs_cpu(got_i, want_i, scores, f"{name} retrieval_cand")
    _card_vs_cpu(got_s, want_s, f"{name} retrieval_cand scores")
    check(bool((got_s[:, 1:] <= got_s[:, :-1]).all()),
          f"{name} retrieval_cand: scores not sorted")
    ms = run_ms(lambda: step(model, ud, td))
    p50 = float(np.median(ms))
    log(f"[recsys] {name} retrieval_cand (1 x {table.shape[0]} candidates, "
        f"k 100): {n_diff} ids differ from the CPU's (near ties only); "
        f"p50 {p50:.4f} ms a call")
    return dict(p50_ms=p50, ids_differing=n_diff)


def phase_recsys(seed: int) -> tuple[dict, dict]:
    """The recsys family's serving path at full width, and SASRec retrieval
    through the port's streaming FreshDiskANN.

    1. FM, DeepFM, xDeepFM (``configs/*.py`` FULL: 39 fields x 1,048,576
       rows x 10) score ``click_stream`` batches through
       ``make_recsys_serve_step`` at serve_p99 (B 512) and serve_bulk
       (B 262,144); FM's ``make_retrieval_step`` at retrieval_cand (1 x
       1,048,576 candidates, k 100).
    2. SASRec FULL (d 50, 50 positions, 2 blocks, 1,048,576 items) encodes
       ``sasrec_stream`` sequences at both shapes, and retrieves at
       retrieval_cand over its item table.  Its item table is a mixture of
       4,096 Gaussians (centres N(0, 4 I), unit noise) scaled by 0.01: the
       structure a trained table has.
    3. The item table, rows normalized, goes into the port's
       ``FreshDiskANN`` at freshdiskann-1b's index knobs (R 64, L_build
       75, L_search 100, alpha 1.2, W 4; PQ m 25 x ksub 256 at d 50):
       ``RECSYS_INDEX`` items bootstrapped, 1 % of them retired with
       ``delete``, the next ``RECSYS_MERGE_THRESHOLD + RECSYS_RO_POINTS /
       4`` items inserted (one threshold StreamingMerge through
       ``insert``), and ``RECSYS_QUERIES`` normalized user embeddings
       served with ``search_batch`` (k 10).  Asserted: no retired item,
       self-hit >= 0.98 over the merged items reachable from the LTI's
       start, the search and insert kernels launched.  Reported: recall
       against exact ``retrieval_topk`` over the live catalog, bootstrap
       seconds, inserts/s, merge seconds, queries/s.
    4. ``l2_rows`` at d 50, ``adc_rows`` at m 25 and ``robust_prune_fp``
       at d 50, on the index's rows and codes, against their plain
       versions, timed.

    Weights and data come from ``seed`` on CPU generators.  The card's
    logits (FM family) and user embeddings (SASRec) on ``check_rows`` of
    each batch are held against the same weights on the CPU
    (``_tolerance``).  Returns (the phase's figures, the kernel readings by
    kernel name)."""
    import copy

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.config import SystemConfig
    from repro_torch.core import pq as pqm
    from repro_torch.core.system import bootstrap_system
    from repro_torch.data.pipelines import click_stream, sasrec_stream
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as rec
    from repro_torch.serving.steps import make_recsys_serve_step
    dev = torch.device("cuda")

    t_phase = time.perf_counter()
    out: dict = {}
    g = np.random.default_rng(seed + 23)

    # ---- 1. the FM family: click scoring and FM's retrieval_cand ------
    for i, name in enumerate(RECSYS_FM):
        cfg = get_arch(name).full_config
        t0 = time.perf_counter()
        cpu_model = rec.init_recsys_params(
            torch.Generator().manual_seed(seed + i), cfg, device="cpu")
        t_init = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = copy.deepcopy(cpu_model).to(dev)
        serve = make_recsys_serve_step(cfg)

        def clicks(B, cfg=cfg):
            return next(click_stream(B, cfg.n_sparse, cfg.rows_per_field,
                                     seed=seed))["ids"]

        res = _serve_shapes(
            name, serve, lambda m, x, cfg=cfg: rec.recsys_forward(m, x, cfg),
            model, cpu_model, clicks, dev)
        if name == "fm":
            table = torch.from_numpy(g.standard_normal(
                (RECSYS_CANDIDATES, cfg.embed_dim)).astype(np.float32)
                * 0.01)
            res["retrieval_cand"] = _retrieval_cand(
                name, cfg, model, cpu_model, clicks(1), table,
                lambda m, u, cfg=cfg: rec.field_lookup(m.V, u, cfg).sum(-2),
                dev)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["init_s"] = t_init
        log(f"[recsys] {name}: {cfg.total_rows} rows x {cfg.embed_dim} "
            f"(+ mlp {cfg.mlp}, cin {cfg.cin_layers}); init on the host "
            f"{t_init:.1f} s; max_memory_allocated {res['peak_gib']:.2f} GiB")
        out[name] = res
        del model, cpu_model
        torch.cuda.empty_cache()

    # ---- 2. SASRec: user embeddings and retrieval_cand ----------------
    cfg = get_arch("sasrec").full_config
    d = cfg.embed_dim
    t0 = time.perf_counter()
    centers = (g.standard_normal((4096, d)) * 2.0).astype(np.float32)
    items = (_mixture(g, centers, cfg.n_items) * 0.01).astype(np.float32)
    cpu_model = rec.init_recsys_params(torch.Generator().manual_seed(seed + 3),
                                       cfg, device="cpu")
    with torch.no_grad():
        cpu_model.item_emb.copy_(torch.from_numpy(items))
    t_data = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    model = copy.deepcopy(cpu_model).to(dev)

    def user_emb(m, seq):
        with torch.no_grad():
            return rec.sasrec_user_embedding(m, seq, cfg)

    def seqs(B, step=0):
        return next(sasrec_stream(B, cfg.seq_len, cfg.n_items, seed=seed,
                                  start_step=step))["seq"]

    res = _serve_shapes("sasrec", user_emb, user_emb, model, cpu_model,
                        seqs, dev)
    res["retrieval_cand"] = _retrieval_cand(
        "sasrec", cfg, model, cpu_model, seqs(1), cpu_model.item_emb.detach(),
        lambda m, u: rec.sasrec_user_embedding(m, u, cfg), dev)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[recsys] sasrec: {cfg.n_items} items x {d}, {cfg.n_blocks} blocks,"
        f" {cfg.seq_len} positions; catalog and weights on the host "
        f"{t_data:.1f} s; max_memory_allocated {res['peak_gib']:.2f} GiB")
    out["sasrec"] = res

    # ---- 3. SASRec retrieval through the streaming FreshDiskANN -------
    norm = items / np.maximum(np.linalg.norm(items, axis=1, keepdims=True),
                              1e-6)
    n_index, merge_threshold = RECSYS_INDEX, RECSYS_MERGE_THRESHOLD
    n_queries = RECSYS_QUERIES
    n_new = merge_threshold + RECSYS_RO_POINTS // 4
    boot = np.arange(1, n_index + 1)
    new = np.arange(n_index + 1, n_index + 1 + n_new)
    retired = g.choice(boot, n_index // 100, replace=False)
    ann = get_arch("freshdiskann-1b").full_config
    scfg = SystemConfig(
        index=dataclasses.replace(ann.index, capacity=RECSYS_CAPACITY, dim=d),
        pq=dataclasses.replace(ann.pq, dim=d, m=25),
        ro_snapshot_points=RECSYS_RO_POINTS, merge_threshold=merge_threshold,
        insert_batch=256, batch_queries=ann.query_batch, merge_block=1024)
    ops.reset_launches()
    t0 = time.perf_counter()
    s = bootstrap_system(norm[boot], boot, scfg, device=dev)
    torch.cuda.synchronize()
    t_boot = time.perf_counter() - t0
    log(f"[recsys] bootstrap_system: {n_index} of {cfg.n_items} items "
        f"(d {d}, PQ m {scfg.pq.m} x {scfg.pq.ksub}) in {t_boot:.1f} s "
        f"({n_index / t_boot:.0f} items/s) into capacity "
        f"{scfg.index.capacity}")
    for e in retired:
        s.delete(int(e))
    t0 = time.perf_counter()
    for e in new:
        s.insert(int(e), norm[e])
    s._flush_inserts()
    torch.cuda.synchronize()
    t_ins = time.perf_counter() - t0
    st = s.stats
    check(st.merges == 1, f"expected one threshold merge, got {st.merges}")
    log(f"[recsys] {len(retired)} retired, then {n_new} new items in "
        f"{t_ins:.2f} s ({n_new / t_ins:.0f} inserts/s with the merge, "
        f"{n_new / (t_ins - st.merge_seconds):.0f} without); merge of "
        f"{merge_threshold} items {st.merge_seconds:.2f} s "
        f"({_fmt_phases(st.merge_phase_seconds)}), Delete phase "
        f"{'local' if st.local_repairs else 'global'}; RW {s.rw.n}")

    qseq = np.concatenate([seqs(1024, step) for step in
                           range(-(-n_queries // 1024))])[:n_queries]
    with torch.no_grad():
        qv = user_emb(model, torch.from_numpy(qseq).to(dev))
        qv = qv / torch.clamp(qv.norm(dim=1, keepdim=True), min=1e-6)
    qv = qv.cpu().numpy()
    s.search_batch(qv[:1024], k=10)                   # warm-up batch
    s.stats.search_latency = type(s.stats.search_latency)(seed=1)
    t0 = time.perf_counter()
    ids, dists = s.search_batch(qv, k=10)
    t_q = time.perf_counter() - t0
    lat = s.stats.search_latency.snapshot()
    check(ids.shape == (n_queries, 10) and bool((ids >= 0).all())
          and bool(np.isfinite(dists).all()), "search_batch results")
    check(not np.isin(ids, retired).any(), "a retired item was returned")
    live = np.concatenate([np.setdiff1d(boot, retired), new])
    table = torch.from_numpy(norm[live]).to(dev)
    exact = []
    for lo in range(0, n_queries, 256):
        _, e = rec.retrieval_topk(torch.from_numpy(qv[lo:lo + 256]).to(dev),
                                  table, 10)
        exact.append(e.cpu().numpy())
    exact = live[np.concatenate(exact)]
    del table

    def recall(found, k):
        return float((found[:, :k, None] == exact[:, None, :k]).any(2).sum(1)
                     .mean() / k)

    r10, r5 = recall(ids, 10), recall(ids, 5)
    log(f"[recsys] search_batch {n_queries} SASRec queries (k 10, L 100, "
        f"W 4, batch_queries 1024): {n_queries / t_q:.0f} queries/s, micro-"
        f"batch p50 {lat['p50'] * 1e3:.1f} ms p99 {lat['p99'] * 1e3:.1f} ms;"
        f" 10-recall@10 {r10:.4f}, 5-recall@5 {r5:.4f} against exact "
        f"retrieval_topk over {len(live)} live items; no retired item")

    merged = new[:merge_threshold]
    self_ids, _ = s.search_batch(norm[merged], k=5)
    hit = (self_ids == merged[:, None]).any(1)
    check(all(s._ext_loc[int(e)][0] == "lti" for e in merged),
          "a merged item is not in the LTI")
    reach = reachable(s.lti.graph)[[s._ext_loc[int(e)][1] for e in merged]]
    self_reach = float(hit[reach].mean())
    rw_ids, _ = s.search_batch(norm[new[merge_threshold:]], k=5)
    rw_hit = float((rw_ids == new[merge_threshold:, None]).any(1).mean())
    log(f"[recsys] self-hit of the {len(merged)} merged items: "
        f"{float(hit.mean()):.4f} in top-5, {int((~reach).sum())} of them "
        f"unreachable from the LTI's start, over the reachable ones "
        f"{self_reach:.4f}; of the {n_new - merge_threshold} in RW "
        f"{rw_hit:.4f}")
    check(self_reach >= 0.98,
          f"self-hit over reachable merged items {self_reach} < 0.98")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"[recsys] launches {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in RECSYS_KERNELS)
          and launches["robust_prune_fp"] + launches["robust_prune_sdc"] > 0,
          f"a kernel of the recsys path never launched: {launches}")
    out["ann"] = dict(
        n_index=n_index, n_new=n_new, n_retired=len(retired),
        bootstrap_s=t_boot, inserts_per_s=n_new / t_ins,
        merge_s=st.merge_seconds,
        merge_phase_s=dict(st.merge_phase_seconds),
        queries_per_s=n_queries / t_q, p50_ms=lat["p50"] * 1e3,
        p99_ms=lat["p99"] * 1e3, recall_10_at_10=r10, recall_5_at_5=r5,
        self_hit_reachable=self_reach, self_hit_rw=rw_hit,
        launches=launches)

    # ---- 4. the kernels at this phase's shapes: d 50 and m 25 ---------
    n_live = int(s.lti.graph.active.sum())
    vecs = s.lti.graph.vectors[:n_live]
    vecs_int = torch.from_numpy(g.integers(-4, 5, tuple(vecs.shape))
                                .astype(np.float32)).to(dev)
    codes = s.lti.codes[:n_live].contiguous()
    qd = torch.from_numpy(qv).to(dev)

    def luts(B):
        return pqm.lut(s.lti.codebook, qd[:B]).contiguous()

    readings = {
        "l2_rows": [shape_entry(
            l2_rows_reading(g, vecs_int, vecs, 1024, 256))],
        "adc_rows": [shape_entry(adc_rows_reading(g, codes, luts, B, 256))
                     for B in (1024, 256)],
        "robust_prune_fp": [shape_entry(prune_fp_reading(
            g, vecs_int, vecs, 256, 203, "insert"))]}
    del vecs_int, codes, qd
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[recsys] phase {out['seconds']:.1f} s")
    del s, model, cpu_model
    torch.cuda.empty_cache()
    return out, readings


FILTERED_KERNELS = ("l2_rows", "adc_rows", "frontier_select", "gather_rows")


@contextlib.contextmanager
def frontier_census():
    """Count ``frontier_select``'s launches by shape while the block runs:
    {"B=.. L=.. K=.. V=..": launches} (the wrapper is replaced in ``ops``
    for the duration; the engine looks it up there at each round)."""
    from repro_torch.kernels import ops
    census: dict = {}
    saved = ops.frontier_select

    def frontier_select(cand_ids, cand_d, new_ids, *args, **kw):
        n0 = ops.LAUNCHES["frontier_select"]
        out = saved(cand_ids, cand_d, new_ids, *args, **kw)
        if ops.LAUNCHES["frontier_select"] > n0:
            key = (f"B={cand_ids.shape[0]} L={cand_ids.shape[1]} "
                   f"K={new_ids.shape[1]} V={args[1].shape[1]}")
            census[key] = census.get(key, 0) + 1
        return out

    ops.frontier_select = frontier_select
    try:
        yield census
    finally:
        ops.frontier_select = saved


def live_points(s) -> tuple:
    """(vectors on the device, ext ids) of every live point of ``s``: the
    LTI's and the temp tiers' rows with an ext id, minus the DeleteList."""
    import torch
    s._flush_inserts()
    vecs, ids = [], []
    dead = np.fromiter(s.deleted_ext, np.int64, len(s.deleted_ext))
    for state, ext in [(s.lti.graph, s.lti_ext_ids)] + [
            (t.state, t.ext_ids) for t in [s.rw] + list(s.ro)]:
        sl = np.nonzero((ext >= 0) & ~np.isin(ext, dead))[0]
        vecs.append(state.vectors[torch.from_numpy(sl).to(
            state.vectors.device)].float())
        ids.append(ext[sl])
    return torch.cat(vecs), np.concatenate(ids)


def widen(sel: float, k: int, L_search: int) -> tuple[int, int]:
    """A post-filter client's k and L for a selectivity (the rule of
    tests/test_filtered.py and benchmarks/bench_filtered.py):
    k_eff = min(256, ceil(k / sel * 1.5)), L = max(L_search, 2 k_eff)."""
    k_eff = k if sel >= 1.0 else min(256, int(np.ceil(k / sel * 1.5)))
    return k_eff, max(L_search, 2 * k_eff)


def phase_filtered(s, data: dict, seed: int) -> dict:
    """Filtered and multi-tenant search on the main path's merged system
    (labelled with the ladder and 4 tenants at bootstrap and insert):

    1. a spec every live point matches (``all_of=(0,)``): ids and dists of
       4 x 1024 queries, and each micro-batch's lane counters (hops, cmps),
       bit-identical to the unfiltered call;
    2. the ladder's selectivities 0.5, 0.1 and 0.01 (k and L widened as
       the reference's clients do: L 100, 150, 512), tenants 0-3 and
       tenant 2 with label 2 (selectivity 0.05, L 300), 4 x 1024 queries
       each: 5-recall@5 of the
       leading 5 rows against brute force over the matching live points
       (>= 0.90 asserted at 1.0, 0.5 and each tenant), no returned id that
       fails the predicate or is deleted, queries/s and micro-batch p50;
    3. ``batch_fanout=False`` filtered equals the filtered fan-out;
    4. ``shard_lti=4`` filtered equals unsharded, and the sharded step over
       4 shards on the card gives the filtered masks' ids, dists, hops and
       cmps of ``unified_search``;
    5. ``frontier_select``'s launches by shape (L 100, 150, 512).

    Returns (the phase's launch counts, frontier_select's census)."""
    import torch
    from repro_torch.core import index as mem
    from repro_torch.core.graph import FilterSpec, LaneStack, shard_lti
    from repro_torch.kernels import ops
    from repro_torch.serving.steps import make_sharded_unified_step
    dev = s.device
    cfg, icfg, k, qs = s.cfg, s.cfg.index, data["k"], data["qs"]
    bq, W = cfg.batch_queries, icfg.beam_width
    nb = len(qs) // bq

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    live_v, live_ids = live_points(s)
    check(len(live_ids) == s.size, f"live points {len(live_ids)} != size "
          f"{s.size}")
    dead = np.fromiter(s.deleted_ext, np.int64, len(s.deleted_ext))
    ops.reset_launches()
    with frontier_census() as census:
        # 1. Selectivity 1.0 is the unfiltered call, bit for bit.
        all_pts = FilterSpec(all_of=(0,))
        want = s.search_batch(qs, k=k)
        got = s.search_batch(qs, k=k, filter=all_pts)
        check(all(np.array_equal(a, b) for a, b in zip(got, want)),
              "a filter every live point matches differs from no filter")
        rw_t, ro_temps, lti_entry = s._capture_lanes()
        bundle = s._lane_bundle(rw_t, ro_temps, lti_entry)
        stack, t_tabs, l_tab = bundle[1:4]
        kk = min(max(k * 2, k + 8), icfg.L_search)
        run_kw = dict(k=k, k_lane=kk, L=icfg.L_search, beam_width=W,
                      rerank=cfg.rerank)
        for b in range(nb):
            q = torch.from_numpy(qs[b * bq:(b + 1) * bq]).to(dev)
            u = mem.unified_search(stack, t_tabs, l_tab,
                                   *s._masks(bundle, None), q, icfg,
                                   **run_kw)
            f = mem.unified_search(stack, t_tabs, l_tab,
                                   *s._masks(bundle, all_pts), q, icfg,
                                   **run_kw)
            for x, y, nm in zip(u, f, ("ids", "dists", "hops", "cmps")):
                check(torch.equal(x, y), f"micro-batch {b}: {nm} of the "
                      "all-points filter differ from the unfiltered ones")
        log(f"[filtered] all_of=(0,) (selectivity 1.0): ids and dists of "
            f"{len(qs)} queries and the hops and cmps of {nb} micro-batches "
            f"equal to the unfiltered call")

        # 2. The ladder, the tenants, a tenant with a label.
        specs = [("sel 1.0", all_pts, 1.0), ("sel 0.5", FilterSpec(
            all_of=(1,)), 0.5), ("sel 0.1", FilterSpec(all_of=(2,)), 0.1),
            ("sel 0.01", FilterSpec(all_of=(3,)), 0.01)]
        specs += [(f"tenant {t}", FilterSpec(tenant=t), 1 / N_TENANTS)
                  for t in range(N_TENANTS)]
        specs.append(("tenant 2 + bit 2", FilterSpec(all_of=(2,), tenant=2),
                      0.05))
        rows = {}
        for name, spec, sel in specs:
            k_eff, L = widen(sel, k, icfg.L_search)
            match = ladder_match(live_ids, spec)
            s.stats.search_latency = type(s.stats.search_latency)(seed=1)
            f0 = s.stats.filtered_searches
            sync()
            t0 = time.perf_counter()
            ids, dists = s.search_batch(qs, k=k_eff, L=L, filter=spec)
            secs = time.perf_counter() - t0
            lat = s.stats.search_latency.snapshot()
            check(s.stats.filtered_searches - f0 == len(qs),
                  f"{name}: filtered_searches counts "
                  f"{s.stats.filtered_searches - f0}")
            got_ids = ids[ids >= 0]
            bad = ~ladder_match(got_ids, spec)
            check(not bad.any(), f"{name}: {int(bad.sum())} returned ids "
                  "fail the predicate")
            check(not np.isin(got_ids, dead).any(),
                  f"{name}: a deleted id was returned")
            top = ids[:, :k]
            recall = _recall(top, qs, live_v[torch.from_numpy(np.nonzero(
                match)[0]).to(dev)], live_ids[match], k, dev)
            rows[name] = dict(sel=round(float(match.mean()), 4), k=k_eff,
                              L=L, recall=recall, qps=len(qs) / secs,
                              p50_ms=lat["p50"] * 1e3,
                              p99_ms=lat["p99"] * 1e3,
                              empty=int((top < 0).sum()))
            log(f"[filtered] {name}: {int(match.sum())} of {len(live_ids)} "
                f"live points match ({match.mean():.4f}); k {k_eff}, L {L}:"
                f" 5-recall@5 {recall:.4f}; {len(qs) / secs:.0f} queries/s, "
                f"micro-batch p50 {lat['p50'] * 1e3:.1f} ms p99 "
                f"{lat['p99'] * 1e3:.1f} ms; {rows[name]['empty']} of the "
                f"{top.size} leading slots empty; no id failing the "
                f"predicate, none deleted")
            if sel >= 0.25:
                check(recall >= 0.90, f"{name}: 5-recall@5 {recall} < 0.90")
        check(s.stats.tenant_searches.get(2, 0) >= 2 * len(qs),
              f"tenant_searches {s.stats.tenant_searches}")

        # 3. The sequential oracle under a filter.
        spec, (k_eff, L) = FilterSpec(all_of=(2,)), widen(0.1, k,
                                                           icfg.L_search)
        want = s.search_batch(qs[:bq], k=k_eff, L=L, filter=spec)
        with _knobs(s, batch_fanout=False):
            seq = s.search_batch(qs[:bq], k=k_eff, L=L, filter=spec)
        check(all(np.array_equal(a, b) for a, b in zip(seq, want)),
              "filtered batch_fanout=False differs from the fan-out")
        log(f"[filtered] batch_fanout=False under all_of=(2,) (k {k_eff}, "
            f"L {L}): {bq} queries equal to the filtered fan-out")

        # 4. The sharded lane under a filter, counters included.
        spec = FilterSpec(tenant=1)
        k_eff, L = widen(1 / N_TENANTS, k, icfg.L_search)
        want = s.search_batch(qs, k=k_eff, L=L, filter=spec)
        with _knobs(s, shard_lti=4):
            got = s.search_batch(qs, k=k_eff, L=L, filter=spec)
        check(all(np.array_equal(a, b) for a, b in zip(got, want)),
              "filtered search_batch with shard_lti=4 differs")
        rw_t, ro_temps, lti_entry = s._capture_lanes()
        bundle = s._lane_bundle(rw_t, ro_temps, lti_entry)
        stack, t_tabs, l_tab = bundle[1:4]
        t_drop, l_drop = s._masks(bundle, spec)
        kk = min(max(k_eff * 2, k_eff + 8), L)
        group = [dev] * 4
        step = make_sharded_unified_step(group, icfg, k=k_eff, k_lane=kk,
                                         L=L, beam_width=W,
                                         rerank=cfg.rerank)
        sg, sc = shard_lti(stack.lti, stack.codes, 4, devices=group)
        sstack = LaneStack(stack.temps, sg, sc, stack.codebook)
        for b in range(nb):
            q = torch.from_numpy(qs[b * bq:(b + 1) * bq]).to(dev)
            a = step(sstack, t_tabs, l_tab, t_drop, l_drop, q)
            u = mem.unified_search(stack, t_tabs, l_tab, t_drop, l_drop, q,
                                   icfg, k=k_eff, k_lane=kk, L=L,
                                   beam_width=W, rerank=cfg.rerank)
            for x, y, nm in zip(a, u, ("ids", "dists", "hops", "cmps")):
                check(torch.equal(x, y), f"filtered sharded step micro-batch"
                      f" {b}: {nm} differ from unified_search")
        del sg, sc, sstack
        log(f"[filtered] tenant 1 with shard_lti=4: search_batch equal to "
            f"unsharded; the sharded step over 4 shards on {dev} equal to "
            f"unified_search under the filtered masks (ids, dists, hops, "
            f"cmps) in {nb} micro-batches")
    sync()
    launches = dict(ops.LAUNCHES)
    log(f"[filtered] frontier_select launches by shape: "
        f"{json.dumps(census)}")
    log(f"[filtered] launches {json.dumps(launches)}")
    log(f"[filtered] summary {json.dumps(rows)}")
    log(f"[filtered] phase {time.perf_counter() - t_phase:.1f} s")
    for L in (150, 512):
        check(any(f" L={L} " in key for key in census) or dev.type != "cuda",
              f"frontier_select never launched at L {L}: {census}")
    missing = [n_ for n_ in FILTERED_KERNELS if not launches[n_]]
    check(not missing or dev.type != "cuda",
          f"kernels of the filtered path never launched: {missing}")
    return launches, census


def repair_inputs(lti, seed: int, B: int = 1024):
    """The repair kernels' graph inputs on the merged LTI: its adjacency,
    1 % of its live points deleted (drawn from ``seed + 7``), the usable
    mask, a block of the first B affected nodes and a block of the first B
    slots; and the generator, for the draws that follow."""
    import torch
    from repro_torch.core.delete import affected_mask
    gr = lti.graph
    dev = gr.device
    rng = np.random.default_rng(seed + 7)
    live = torch.nonzero(gr.active)[:, 0].cpu().numpy()
    deleted = torch.zeros_like(gr.deleted)
    deleted[torch.from_numpy(rng.choice(live, len(live) // 100,
                                        replace=False)).to(dev)] = True
    usable = gr.active & ~deleted
    adj = gr.adjacency
    ids = affected_mask(adj, deleted, usable).nonzero()[:B, 0].int()
    block = torch.arange(B, dtype=torch.int32, device=dev)
    return adj, deleted, usable, ids, block, rng


def repair_kernel_records(lti, seed: int, B: int = 1024) -> dict:
    """The two delete-repair kernels against their plain versions at the
    main path's block shape (B 1024, R 64), on the merged LTI's real
    adjacency with 1 % of its live points deleted: a block of affected
    nodes (the local sweep's; every node is repaired).  Integer inputs
    (an integer table, integer SDC tables) must give equal rows; on the
    real inputs (the PQ-decoded table, the codebook's SDC tables) the
    share of differing rows is reported.  Also a block of consecutive
    slots (the global sweep's: most of its slots leave at once): equal
    rows on integer inputs, its time and its bound."""
    import torch
    from repro_torch.core import pq as pqm
    from repro_torch.core.config import PQConfig
    from repro_torch.kernels import ops, ref
    gr = lti.graph
    dev = gr.device
    adj, deleted, usable, ids, block, rng = repair_inputs(lti, seed, B)
    R, alpha, cap = gr.R, 1.2, 8
    pq_cfg = PQConfig(dim=gr.dim, m=lti.codes.shape[1],
                      ksub=lti.codebook.centroids.shape[1])
    decoded = pqm.decode(lti.codebook, lti.codes, pq_cfg).contiguous()
    d, m, ksub = gr.dim, pq_cfg.m, pq_cfg.ksub
    table_int = torch.from_numpy(rng.integers(-3, 4, (gr.capacity, d)).astype(
        np.float32)).to(dev)
    tabs = pqm.sdc_tables(lti.codebook).contiguous()
    tabs_int = torch.from_numpy(rng.integers(0, 9, (m, ksub, ksub)).astype(
        np.float32)).to(dev)
    recs = {}

    def footprint(operands, payload_bytes, cover, flop_per_eval):
        """Bytes and operations these inputs need (each read once)."""
        rows, nbr_del, exp, exp_ok, usable_c, d_p, payload = operands[:7]
        p, live_ = operands[-2], operands[-1]
        cand, ok = ref.delete_repair_assemble_ref(rows, nbr_del, exp, exp_ok,
                                                  usable_c, p)
        changed = live_ & nbr_del.any(1)
        ok = ok & changed[:, None]
        n_cand = int(ok.sum())
        n_par = int((exp_ok & changed[:, None]).sum())
        lanes = int(changed.sum()) * R + n_par * R
        work = prune_work(d_p, ok, cover(payload), alpha, R)
        nbytes = (B * R * 4 * 2 + B * R + B + n_par * R * 4 + lanes
                  + (n_cand + B) * payload_bytes)
        return nbytes, float(flop_per_eval * (n_cand + work))

    for name, args_int, args_real, form, payload_bytes, cover, fpe in (
            ("delete_repair_fp", (table_int,), (decoded,),
             ref.repair_operands_fp, d * 4, fp_cover, 3 * d),
            ("delete_repair_sdc", (lti.codes, tabs_int), (lti.codes, tabs),
             lambda *a: ref.repair_operands_sdc(*a, cap), m,
             lambda codes: (lambda st: ref.sdc_cover_ref(tabs, codes, st)),
             m)):
        kw = dict(alpha=alpha, R=R, **({"cap": cap} if "sdc" in name
                                       else {}))
        fn = getattr(ops, name)
        plain = getattr(ref, name + "_ref")
        got = fn(adj, deleted, usable, *args_int, ids, **kw)
        want = plain(*form(adj, deleted, usable, *args_int, ids), alpha=alpha,
                     R=R)
        check(torch.equal(got, want), f"{name}: integer inputs differ")
        operands = form(adj, deleted, usable, *args_real, ids)
        got = fn(adj, deleted, usable, *args_real, ids, **kw)
        want = plain(*operands, alpha=alpha, R=R)
        n_diff = int((got != want).any(1).sum())
        check(n_diff <= 0.01 * B, f"{name}: {n_diff} of {B} rows differ")
        t = launch_times(lambda: fn(adj, deleted, usable, *args_real, ids,
                                    **kw))
        got = fn(adj, deleted, usable, *args_int, block, **kw)
        want = plain(*form(adj, deleted, usable, *args_int, block),
                     alpha=alpha, R=R)
        check(torch.equal(got, want),
              f"{name}: integer inputs differ (consecutive block)")
        t_block = launch_times(lambda: fn(adj, deleted, usable, *args_real,
                                          block, **kw))
        ops_block = form(adj, deleted, usable, *args_real, block)
        nb_block, nf_block = footprint(ops_block, payload_bytes, cover, fpe)
        if "sdc" in name:
            nb_block += m * ksub * ksub * 4
        del ops_block
        bnd_block = bound_ms(nb_block, nf_block)
        plain_ms = time_ms(lambda: plain(*form(adj, deleted, usable,
                                               *args_real, ids),
                                         alpha=alpha, R=R), iters=2,
                           warmup=1)
        nbytes, nflops = footprint(operands, payload_bytes, cover, fpe)
        if "sdc" in name:
            nbytes += m * ksub * ksub * 4
        C = operands[5].shape[1]
        del operands
        torch.cuda.empty_cache()
        bnd = bound_ms(nbytes, nflops)
        log(f"[kernels] {name} B={B} R={R} C={C} (1 % deleted, affected "
            f"block): integer equal, {n_diff} of {B} real-input rows differ"
            f"  kernel {_fmt_times(t)}  plain {plain_ms:.4f} ms  bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); a block of consecutive slots "
            f"(integer equal) {_fmt_times(t_block)}, bound "
            f"{bnd_block[0]:.4f} ms ({bnd_block[1]})")
        recs[name] = kernel_record(
            name, err=0.0, times=t, plain_ms=plain_ms, nbytes=nbytes,
            nflops=nflops, library_ms=None,
            shape=f"B={B} R={R} C={C} affected block, 1 % deleted; "
            f"real-input rows differing {n_diff}/{B}; consecutive block "
            f"{t_block['ms']:.4f} ms, bound {bnd_block[0]:.4f} ms")
        recs[name].update(
            rows_differing=n_diff, block_ms=t_block["ms"],
            block_device_ms=t_block["device_ms"],
            block_host_us=t_block["host_us"], block_bound_ms=bnd_block[0],
            block_bound_by=bnd_block[1])
    return recs


def gather_kernel_record(lti, seed: int, B: int = 1024, W: int = 4) -> dict:
    """``gather_rows`` against its plain version at the main path's shape:
    B 1024 queries x W 4 frontier ids into the merged LTI's adjacency
    (R 64), some ids negative and some repeated (within and across rows);
    must be equal.  Times kernel, plain
    version and ``torch.index_select`` (the one PyTorch call for the same
    gather, without the INVALID rows, on the ids clamped at 0)."""
    import torch
    from repro_torch.kernels import ops, ref
    adj = lti.graph.adjacency
    N, R = adj.shape
    dev = adj.device
    rng = np.random.default_rng(seed + 9)
    live = torch.nonzero(lti.graph.active)[:, 0].cpu().numpy()
    ids_np = rng.choice(live, (B, W)).astype(np.int32)
    ids_np[rng.random((B, W)) < 0.1] = -1
    ids_np[1::7, 1] = ids_np[1::7, 0]              # repeated within a row
    ids_np[2::5] = ids_np[0]                       # repeated across rows
    ids = torch.from_numpy(ids_np).to(dev)
    check(torch.equal(ops.gather_rows(adj, ids),
                      ref.gather_rows_ref(adj, ids)),
          "gather_rows differs from its plain version")
    safe = ids.clamp(min=0).flatten().long()
    t = launch_times(lambda: ops.gather_rows(adj, ids))
    plain = time_ms(lambda: ref.gather_rows_ref(adj, ids))
    lib = launch_times(lambda: torch.index_select(adj, 0, safe))
    n_valid = int((ids_np >= 0).sum())
    nbytes = n_valid * R * 4 + B * W * R * 4 + B * W * 4
    bnd = bound_ms(nbytes, 0.0)
    log(f"[kernels] gather_rows B={B} W={W} R={R} N={N}: bit-identical "
        f"({B * W - n_valid} negative ids)  kernel {_fmt_times(t)}  plain "
        f"{plain:.4f} ms  index_select {_fmt_times(lib)}  bound "
        f"{bnd[0]:.4f} ms ({bnd[1]})")
    log("[kernels] gather_rows host path, us per call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in gather_breakdown(adj, ids).items()))
    return {"gather_rows": kernel_record(
        "gather_rows", err=0.0, times=t, plain_ms=plain, nbytes=nbytes,
        nflops=0.0, library_ms=lib["ms"],
        shape=f"B={B} W={W} R={R} N={N}, {B * W - n_valid} ids < 0; "
        f"index_select device {_fmt_ms(lib['device_ms'])}, host "
        f"{lib['host_us']:.1f} us/call")}


def gather_breakdown(table, ids) -> dict:
    """Host microseconds per call of each part of ``ops.gather_rows``' path
    on the card: the checks, the output's allocation, the stream handle,
    the pointers, the bare ctypes call (which launches the kernel) and the
    whole wrapper."""
    import torch
    from repro_torch.kernels import ops
    name = "gather_rows"
    out = torch.empty((*ids.shape, table.shape[1]), dtype=torch.int32,
                      device=ids.device)
    fn = ops._FNS[name]
    args = (table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.numel(),
            table.shape[1], ops._stream(ids))

    def checks():
        ops._check(name, table, torch.int32, 2, "table")
        ops._on_cuda(name, (table, ids), True)

    parts = {
        "checks": checks,
        "allocation": lambda: torch.empty(
            (*ids.shape, table.shape[1]), dtype=torch.int32,
            device=ids.device),
        "stream": lambda: ops._stream(ids),
        "pointers": lambda: (ops._ptr(table), ops._ptr(ids), ops._ptr(out)),
        "ctypes call": lambda: fn(*args),
        "whole wrapper": lambda: ops.gather_rows(table, ids),
    }
    return {k: host_us(f) for k, f in parts.items()}


def topk_kernel_record(seed: int, Q: int = 1024, k: int = 5) -> dict:
    """``block_topk`` against its plain version at the cross-shard merge's
    shapes: Q 1024 queries x N 2,560 candidates (the freshdiskann-1b
    deployment's 512 shards x k 5), N 20 (this script's 4 shards x k 5) and
    N 15 (3 shards x k 5: not a multiple of 4, so the kernel's single-value
    loads), k 5.  Gaussian distances, and integer ones with ties, +-inf and a NaN
    row: values and ids must be equal (NaN where the plain version has
    NaN).  Times kernel, plain version and ``torch.topk(largest=False,
    sorted=True)`` (which breaks ties otherwise: time only); the record is
    the N 2,560 shape."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    g = np.random.default_rng(seed + 13)
    rec = None
    for N in (2560, 20, 15):
        ids = torch.from_numpy(g.permutation(1 << 22)[:N].astype(
            np.int32)).to(dev)
        di = g.integers(0, 6, (Q, N)).astype(np.float32)
        di[g.random((Q, N)) < 0.1] = np.inf
        di[g.random((Q, N)) < 0.02] = -np.inf
        di[Q // 3, N // 2] = np.nan
        dg = g.standard_normal((Q, N)).astype(np.float32)
        for kind, x in (("integer", di), ("Gaussian", dg)):
            xd = torch.from_numpy(x).to(dev)
            gd, gi = ops.block_topk(xd, ids, k)
            wd, wi = ref.block_topk_ref(xd, ids, k)
            nan = torch.isnan(wd)
            check(torch.equal(gi, wi) and torch.equal(torch.isnan(gd), nan)
                  and torch.equal(gd[~nan], wd[~nan]),
                  f"block_topk N={N} ({kind}) differs from its plain version")
        xd = torch.from_numpy(dg).to(dev)
        t = launch_times(lambda: ops.block_topk(xd, ids, k))
        plain = time_ms(lambda: ref.block_topk_ref(xd, ids, k))
        lib = launch_times(lambda: torch.topk(xd, k, dim=1, largest=False,
                                              sorted=True))
        nbytes = Q * N * 4 + N * 4 + Q * k * 8
        bnd = bound_ms(nbytes, float(Q * N))
        log(f"[kernels] block_topk Q={Q} N={N} k={k}: bit-identical on "
            f"integer (ties, +-inf, a NaN row) and Gaussian inputs  kernel "
            f"{_fmt_times(t)}  plain {plain:.4f} ms  torch.topk "
            f"{_fmt_times(lib)}  bound {bnd[0]:.4f} ms ({bnd[1]})")
        if rec is None:
            rec = kernel_record("block_topk", err=0.0, times=t,
                                plain_ms=plain, nbytes=nbytes,
                                nflops=float(Q * N), library_ms=lib["ms"],
                                shape=f"Q={Q} N={N} k={k}")
    return {"block_topk": rec}


STORAGE_KERNELS = ("l2_rows", "adc_rows", "frontier_select",
                   "robust_prune_fp", "delete_repair_fp", "gather_rows")


def phase_storage(s, data: dict, seed: int, min_free_gib: float = 8.0,
                  profile: bool = False) -> dict:
    """The storage tier at the main path's shape, on its merged LTI (no
    second bootstrap):

    1. a system over ``s.lti`` with ``storage_dir``, ``wal_dir`` and
       ``snapshot_dir`` (prefetch depth 1, 8 MB cache: the defaults)
       writes the layout; 1 % of the LTI's live points are deleted;
    2. 4 x 1024 queries through ``search_disk``: 5-recall@5 >= 0.90, no
       deleted id, ids and dists equal to ``search_batch``'s, and
       io_rows_read + io_cache_hits equal to the rows requested;
    3. 1024 queries beam-searched through ``HBMSource`` (the
       ``gather_rows`` kernel) and ``DenseSource`` (PQ, L 100, W 4): all
       seven result fields equal, a ``gather_rows`` launch per round;
    4. merge_threshold + ro_points / 4 inserts (one threshold merge that
       delta-patches the layout, snapshots ``merge_1`` and truncates the
       WAL), then ro_points / 2 inserts and 1 % more deletes, with no
       search between them;
    5. a "crash" (storage and WAL closed; the live system kept as the
       twin) and a fresh system's ``recover()``: the LTI, ``size``, the
       DeleteList and ``search_batch`` equal the twin's, every acknowledged
       insert found in its top-5 (>= 0.98 over the points reachable in
       their tier), no deleted id returned.

    Writes under one temporary directory in ``build/`` and fails first if
    it has under ``min_free_gib`` free.  With ``profile``, also runs one
    ``search_disk`` micro-batch and the ``HBMSource`` search under
    torch.profiler (after the checks of steps 2 and 3).  Returns the
    launch counts of the phase."""
    import torch
    from repro_torch.core.graph import FilterSpec
    from repro_torch.core.search import PQBackend, beam_search
    from repro_torch.core.system import FreshDiskANN
    from repro_torch.core.wal import OP_INSERT_LABELED, replay
    from repro_torch.kernels import ops
    from repro_torch.storage import HBMSource, open_layout
    dev = s.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg, icfg, k, qs = s.cfg, s.cfg.index, data["k"], data["qs"]
    g = np.random.default_rng(seed + 11)
    n_new = cfg.merge_threshold + cfg.ro_snapshot_points // 4
    n_tail = cfg.ro_snapshot_points // 2
    new = _mixture(g, data["centers"], n_new + n_tail)
    id0 = 20_000_000
    table = s.lti_ext_ids
    gr = s.lti.graph
    usable = (gr.active & ~gr.deleted).cpu().numpy()
    live_ext = table[(table >= 0) & usable]
    perm = g.permutation(live_ext)
    n_del = len(live_ext) // 100
    dels, dels2 = perm[:n_del], perm[n_del:2 * n_del]

    BUILD.mkdir(exist_ok=True)
    free = shutil.disk_usage(BUILD).free
    log(f"[storage] {free / 2**30:.1f} GiB free under {BUILD}")
    check(free >= min_free_gib * 2**30,
          f"under {min_free_gib} GiB free under {BUILD} for the layout, a "
          f"snapshot layout, temps and the WAL")
    ops.reset_launches()
    with tempfile.TemporaryDirectory(dir=BUILD, prefix="storage-") as tmp:
        scfg = _storage_cfg(cfg, Path(tmp))
        sync()
        t0 = time.perf_counter()
        live = FreshDiskANN(scfg, lti=s.lti, lti_ext_ids=table.copy(),
                            device=dev, lti_labels=s.lti_labels.copy())
        t_write = time.perf_counter() - t0
        log(f"[storage] layout of capacity {icfg.capacity} written in "
            f"{t_write:.2f} s ({live.stats.storage_bytes_written / 2**30:.2f}"
            f" GiB: topology.bin, data.bin, meta.npz); prefetch depth "
            f"{scfg.prefetch_depth}, cache {scfg.adjacency_cache_mb} MB")
        for e in dels:
            live.delete(int(e))

        # 2. search_disk, micro-batch by micro-batch, beside search_batch.
        nb = len(qs) // 1024
        disk_ids, disk_d, t_disk = [], [], []
        for b in range(nb):
            q = qs[b * 1024:(b + 1) * 1024]
            st0 = live._disk_searcher_get().stats.snapshot()
            io0 = [getattr(live.stats, f) for f in IO_FIELDS[:3]]
            t0 = time.perf_counter()
            ids, d = live.search_disk(q, k=k)
            t_disk.append(time.perf_counter() - t0)
            st1 = live._disk_searcher_get().stats.snapshot()
            io = {key: st1[key] - st0[key] for key in st1}
            reads = live.stats.io_rows_read - io0[0]
            hits = live.stats.io_cache_hits - io0[1]
            check(reads + hits == io["rows_requested"],
                  f"search_disk micro-batch {b}: reads {reads} + cache hits "
                  f"{hits} != rows requested {io['rows_requested']}")
            log(f"[storage] search_disk micro-batch {b}: "
                f"{t_disk[-1] * 1e3:.1f} ms; IOStats {json.dumps(io)}")
            disk_ids.append(ids)
            disk_d.append(d)
        disk_ids, disk_d = np.concatenate(disk_ids), np.concatenate(disk_d)
        live.stats.search_latency = type(live.stats.search_latency)(seed=1)
        t0 = time.perf_counter()
        ids_b, d_b = live.search_batch(qs, k=k)
        t_batch = time.perf_counter() - t0
        lat = live.stats.search_latency.snapshot()
        check(np.array_equal(disk_ids, ids_b) and np.array_equal(disk_d, d_b),
              "search_disk differs from search_batch")
        check(not np.isin(disk_ids, dels).any(),
              "search_disk returned a deleted id")
        slots = np.nonzero((table >= 0) & usable & ~np.isin(table, dels))[0]
        recall = _recall(disk_ids, qs, gr.vectors[torch.from_numpy(
            slots).to(dev)], table[slots], k, dev)
        check(recall >= 0.90, f"search_disk recall {recall} < 0.90")
        log(f"[storage] search_disk {len(qs)} queries: "
            f"{len(qs) / sum(t_disk):.0f} queries/s, micro-batch p50 "
            f"{np.percentile(t_disk, 50) * 1e3:.1f} ms; search_batch "
            f"{len(qs) / t_batch:.0f} queries/s, p50 {lat['p50'] * 1e3:.1f} "
            f"ms; equal ids and dists; 5-recall@5 {recall:.4f} over "
            f"{len(slots)} live points")
        # Filtered: the disk lane against the layout's label tables.
        spec = FilterSpec(tenant=1)
        k_eff, L_f = widen(1 / N_TENANTS, k, icfg.L_search)
        t0 = time.perf_counter()
        fd = live.search_disk(qs[:1024], k=k_eff, L=L_f, filter=spec)
        t_fd = time.perf_counter() - t0
        fb = live.search_batch(qs[:1024], k=k_eff, L=L_f, filter=spec)
        check(all(np.array_equal(a, b) for a, b in zip(fd, fb)),
              "filtered search_disk differs from filtered search_batch")
        check(ladder_match(fd[0][fd[0] >= 0], spec).all()
              and not np.isin(fd[0], dels).any(),
              "filtered search_disk returned an id failing the predicate or "
              "deleted")
        log(f"[storage] search_disk under tenant 1 (k {k_eff}, L {L_f}), "
            f"1024 queries: {t_fd * 1e3:.1f} ms, equal to the filtered "
            f"search_batch; no id of another tenant, none deleted")

        # 3. HBMSource == DenseSource through the gather_rows kernel.
        lg = live.lti.graph
        qd = torch.from_numpy(qs[:1024]).to(dev)
        backend = PQBackend(live.lti.codes, live.lti.codebook)
        kw = dict(L=100, max_visits=icfg.visits_bound(100), beam_width=4,
                  use_kernel=icfg.kernel_enabled(dev))
        src = HBMSource(lg.adjacency, lg.active)
        sync()
        t0 = time.perf_counter()
        dense = beam_search(lg.adjacency, lg.active, lg.start, qd, backend,
                            **kw)
        sync()
        t_dense = time.perf_counter() - t0
        before = ops.LAUNCHES["gather_rows"]
        hbm = beam_search(None, None, lg.start, qd, backend, source=src,
                          R=icfg.R, **kw)
        n_gather = ops.LAUNCHES["gather_rows"] - before
        sync()
        t0 = time.perf_counter()
        beam_search(None, None, lg.start, qd, backend, source=src, R=icfg.R,
                    **kw)
        sync()
        t_hbm = time.perf_counter() - t0
        rounds = int(hbm.n_hops.max())
        for f in hbm._fields:
            check(torch.equal(getattr(hbm, f), getattr(dense, f)),
                  f"HBMSource differs from DenseSource in {f}")
        check(n_gather >= rounds or not cuda,
              f"gather_rows launched {n_gather} times for {rounds} rounds")
        log(f"[storage] HBMSource beam search, 1024 queries, L 100, W 4: all "
            f"seven fields equal to DenseSource; {rounds} rounds, "
            f"{n_gather} gather_rows launches; {t_hbm * 1e3:.1f} ms vs "
            f"DenseSource {t_dense * 1e3:.1f} ms")
        if profile:
            profile_run("search_disk, 1024 queries",
                        lambda: live.search_disk(qs[:1024], k=k))
            profile_run("HBMSource beam search, 1024 queries",
                        lambda: beam_search(None, None, lg.start, qd,
                                            backend, source=src, R=icfg.R,
                                            **kw))

        # 4. Inserts through a threshold merge, then a tail after it.
        sync()
        t0 = time.perf_counter()
        for i in range(n_new):
            live.insert(id0 + i, new[i], labels=ladder(id0 + i),
                        tenant=(id0 + i) % N_TENANTS)
        sync()
        t_ins = time.perf_counter() - t0
        st = live.stats
        snap = live.latest_snapshot()
        check(st.merges == 1 and snap is not None
              and snap.endswith("merge_1"),
              f"expected one threshold merge and merge_1: {st.merges}, "
              f"{snap}")
        lay = open_layout(live._storage_path())
        check(np.array_equal(lay.label_bits, live.lti_labels.bits)
              and np.array_equal(lay.label_tenant, live.lti_labels.tenant),
              "the patched layout's label tables differ from lti_labels")
        lay.close()
        for i in range(n_new, n_new + n_tail):
            live.insert(id0 + i, new[i], labels=ladder(id0 + i),
                        tenant=(id0 + i) % N_TENANTS)
        for e in dels2:
            live.delete(int(e))
        ph = st.merge_phase_seconds
        log(f"[storage] {n_new} inserts in {t_ins:.2f} s with the WAL, the "
            f"threshold merge {st.merge_seconds:.2f} s "
            f"({_fmt_phases(ph)}); patch: {st.storage_rows_patched} "
            f"adjacency rows in {st.storage_blocks_patched} blocks, "
            f"{st.storage_bytes_written / 2**20:.1f} MiB written in all; "
            f"then {n_tail} inserts and {len(dels2)} deletes; WAL "
            f"{os.path.getsize(live.wal.path) / 2**20:.1f} MiB")

        # 5. Crash, recover, twin check.
        live.close_storage()
        live.wal.close()
        ops_ = [op for op, _, _ in replay(live.wal.path)]
        check(ops_.count(OP_INSERT_LABELED) == n_new - cfg.merge_threshold
              + n_tail, f"the WAL holds {ops_.count(OP_INSERT_LABELED)} "
              "labelled inserts")
        sync()
        t0 = time.perf_counter()
        rec = FreshDiskANN(scfg, device=dev)
        n_rec = rec.recover()
        sync()
        t_rec = time.perf_counter() - t0
        log(f"[storage] recovery from {Path(snap).name} + the WAL suffix: "
            f"{n_rec} records replayed in {t_rec:.2f} s")
        check(n_rec == (n_new - cfg.merge_threshold) + n_tail + len(dels2),
              f"replayed {n_rec} records")
        for f in ("adjacency", "active", "deleted"):
            check(torch.equal(getattr(rec.lti.graph, f),
                              getattr(live.lti.graph, f)),
                  f"recovered LTI {f} differs")
        check(torch.equal(rec.lti.codes, live.lti.codes),
              "recovered LTI codes differ")
        check(rec.size == live.size and rec.deleted_ext == live.deleted_ext,
              f"recovered size {rec.size} / DeleteList differ from the "
              f"twin's {live.size}")
        check(all(np.array_equal(a, b) for a, b in zip(
            label_rows(rec), label_rows(live))),
            "the recovered ext id -> (tenant, bits) map differs from the "
            "twin's")
        r_ids, r_d = rec.search_batch(qs[:1024], k=k)
        t_ids, t_d = live.search_batch(qs[:1024], k=k)
        check(np.array_equal(r_ids, t_ids) and np.array_equal(r_d, t_d),
              "the recovered system's search differs from the twin's")
        rd_ids, rd_d = rec.search_disk(qs[:1024], k=k)
        check(np.array_equal(rd_ids, r_ids) and np.array_equal(rd_d, r_d),
              "the recovered system's search_disk differs from its "
              "search_batch")
        ext = id0 + np.arange(n_new + n_tail)
        hit_ids, _ = rec.search_batch(new, k=k)
        hit = (hit_ids == ext[:, None]).any(1)
        reach = {"lti": reachable(rec.lti.graph),
                 "rw": reachable(rec.rw.state)}
        loc = [rec._ext_loc[int(e)] for e in ext]
        ok_reach = np.array([reach[t][sl] for t, sl in loc])
        self_reach = float(hit[ok_reach].mean())
        gone = np.concatenate([dels, dels2])
        check(not np.isin(hit_ids, gone).any() and not np.isin(r_ids, gone)
              .any(), "a deleted id was returned after recovery")
        log(f"[storage] recovered system twins the live one (LTI, size "
            f"{rec.size}, DeleteList, search_batch ids and dists; "
            f"search_disk == search_batch); acknowledged inserts found in "
            f"top-5: {float(hit.mean()):.4f} of {len(ext)} "
            f"({int((~ok_reach).sum())} unreachable in their tier), "
            f"{self_reach:.4f} over the reachable ones")
        check(self_reach >= 0.98,
              f"self-hit of acknowledged inserts {self_reach} < 0.98")
        rec.close_storage()
        rec.wal.close()
        del rec, live
    sync()
    launches = dict(ops.LAUNCHES)
    log(f"[storage] launches {json.dumps(launches)}")
    missing = [n for n in STORAGE_KERNELS if not launches[n]]
    check(not missing, f"kernels of the storage path never launched: "
          f"{missing}")
    return launches


@contextlib.contextmanager
def _knobs(s, **kw):
    """Run with ``s.cfg`` replaced by a copy with ``kw``; restored after."""
    import dataclasses
    old = s.cfg
    s.cfg = dataclasses.replace(old, **kw)
    try:
        yield s
    finally:
        s.cfg = old


def phase_serving(s, data: dict, seed: int,
                  shard_points: int = 131_072) -> dict:
    """The serving slice at the main path's shape, on its merged system (no
    second bootstrap of its LTI):

    1. ``search_batch`` with ``shard_lti=4`` (capped at the card count)
       equals ``shard_lti=0``; ``make_sharded_unified_step`` over an
       explicit group of 4 shards on the one card serves 4 x 1024 queries
       with the unsharded ``unified_search``'s ids, dists, hops and cmps;
    2. ``batch_fanout=False`` (one search per tier, host aggregation)
       equals the unified fan-out;
    3. ``autotune_beam`` calibrates W: each ``BeamPoint`` and the pick;
    4. a ``BatchScheduler`` on the wall clock in front of a ``ReplicaSet``
       (4 replicas asked, degraded to the card count) serves the 4,096
       queries submitted in bursts of 512: every ticket's row equals the
       direct ``search_batch``'s;
    5. the freshdiskann-1b shard deployment (``launch.ann_steps``) over 4
       shards on the card: shard 0 the merged LTI, shards 1-3 built from
       ``shard_points`` further points each of the same mixture, at the
       same capacity, with shard 0's codebook.  ``make_distributed_search``
       (one ``block_topk`` launch per call) reaches 5-recall@5 >= 0.90 over
       the union and equals the per-shard ``search_lti``s merged on the
       host by a stable sort; ``make_distributed_insert`` takes 4,096
       points (1,024 a shard); ``make_distributed_merge`` takes 4,096 more
       with 1 % of each shard's live points deleted: no deleted point is
       returned after it, recall stays >= 0.90;
    6. ``launch.serve.main`` at its defaults.

    Returns the launch counts of the phase."""
    import torch
    from repro_torch.core import autotune
    from repro_torch.core import index as mem
    from repro_torch.core.graph import LaneStack, shard_lti
    from repro_torch.core.lti import build_lti, search_lti
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.ann_steps import (make_distributed_insert,
                                              make_distributed_merge,
                                              make_distributed_search,
                                              shard_block, stack_blocks)
    from repro_torch.serving import BatchScheduler, ReplicaSet
    from repro_torch.serving.steps import make_sharded_unified_step
    dev = s.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg, icfg, k, qs = s.cfg, s.cfg.index, data["k"], data["qs"]
    bq, L, W = cfg.batch_queries, icfg.L_search, icfg.beam_width
    nb = len(qs) // bq
    kk = min(max(k * 2, k + 8), L)
    ops.reset_launches()

    # 1. The row-sharded lane.
    want = s.search_batch(qs, k=k)
    with _knobs(s, shard_lti=4):
        got = s.search_batch(qs, k=k)
        n_eff = s.lti_shards
    check(all(np.array_equal(a, b) for a, b in zip(got, want)),
          "search_batch with shard_lti=4 differs from shard_lti=0")
    rw_t, ro_temps, lti_entry = s._capture_lanes()
    key, stack, t_tabs, l_tab, tables_np = s._lane_bundle(rw_t, ro_temps,
                                                          lti_entry)[:5]
    t_drop, l_drop = s._drop_mask(key, tables_np)
    group = [dev] * 4
    step = make_sharded_unified_step(group, icfg, k=k, k_lane=kk, L=L,
                                     beam_width=W)
    sg, sc = shard_lti(stack.lti, stack.codes, 4, devices=group)
    sstack = LaneStack(stack.temps, sg, sc, stack.codebook)
    t_sh, t_un = [], []
    for b in range(nb):
        q = torch.from_numpy(qs[b * bq:(b + 1) * bq]).to(dev)
        sync()
        t0 = time.perf_counter()
        a = step(sstack, t_tabs, l_tab, t_drop, l_drop, q)
        sync()
        t1 = time.perf_counter()
        u = mem.unified_search(stack, t_tabs, l_tab, t_drop, l_drop, q, icfg,
                               k=k, k_lane=kk, L=L, beam_width=W,
                               rerank=cfg.rerank)
        sync()
        t_sh.append(t1 - t0)
        t_un.append(time.perf_counter() - t1)
        for x, y, nm in zip(a, u, ("ids", "dists", "hops", "cmps")):
            check(torch.equal(x, y), f"sharded step micro-batch {b}: {nm} "
                  "differ from the unsharded unified_search")
    log(f"[serving] shard_lti=4 -> {n_eff} shard(s) on this card: "
        f"search_batch of {len(qs)} queries equal to shard_lti=0; "
        f"make_sharded_unified_step over 4 shards on {dev} (blocks of "
        f"{sg[0].capacity} rows): ids, dists, hops, cmps equal to "
        f"unified_search in {nb} micro-batches of {bq}; ms per micro-batch "
        f"sharded {[round(t * 1e3, 1) for t in t_sh]} vs unsharded "
        f"{[round(t * 1e3, 1) for t in t_un]}")
    del sg, sc, sstack

    # 2. The sequential oracle.
    with _knobs(s, batch_fanout=False):
        d0 = s.stats.search_dispatches
        sync()
        t0 = time.perf_counter()
        seq = s.search_batch(qs[:bq], k=k)
        t_seq = time.perf_counter() - t0
        n_disp = s.stats.search_dispatches - d0
    check(all(np.array_equal(a, b[:bq]) for a, b in zip(seq, want)),
          "batch_fanout=False differs from the unified fan-out")
    log(f"[serving] batch_fanout=False: {bq} queries in {t_seq * 1e3:.1f} "
        f"ms over {n_disp} per-tier searches (LTI, RW, {len(s.ro)} RO), "
        f"equal to the unified fan-out")

    # 3. The autotuner.
    with _knobs(s, autotune_beam=True):
        s._tuned_w = None
        t0 = time.perf_counter()
        points = s._beam_sweep(qs)
        t_cal = time.perf_counter() - t0
        pick = autotune.pick_beam_width(points)
        ids_a, d_a = s.search_batch(qs[:bq], k=k)
        tuned = s._tuned_w
    s._tuned_w = None
    check(tuned == pick and ids_a.shape == (bq, k)
          and bool(np.isfinite(d_a).all()),
          f"autotune: cached W {tuned} != the sweep's pick {pick}")
    for p in points:
        log(f"[serving] BeamPoint W={p.W}: hops {p.hops:.3f} cmps "
            f"{p.cmps:.3f} cost {p.cost(autotune.BeamCostModel()):.3f} "
            f"({p.seconds * 1e3:.1f} ms)")
    log(f"[serving] autotune_beam picks W={pick} (sweep {t_cal:.2f} s, "
        f"probe of 8 queries through the unified fan-out)")

    # 4. BatchScheduler (wall clock, worker thread) -> ReplicaSet.
    rs = ReplicaSet(s, 4)
    with _knobs(s, slo_ms=250.0, serve_queue_capacity=len(qs),
                dispatch_estimate_ms=60.0):
        st = s.stats
        shed0, batches0 = st.shed_requests, st.batches_dispatched
        miss0 = st.deadline_misses
        sched = BatchScheduler(s, k=k, serve=rs.search_batch)
        sched.start()
        tickets = []
        t0 = time.perf_counter()
        try:
            for lo in range(0, len(qs), 512):
                tickets += [sched.submit(q) for q in qs[lo:lo + 512]]
                time.sleep(0.03)
            for t in tickets:
                if t is not None:
                    t.result(timeout=300.0)
        finally:
            sched.stop()
        t_sched = time.perf_counter() - t0
    served = [i for i, t in enumerate(tickets) if t is not None]
    for i in served:
        check(np.array_equal(tickets[i].ids, want[0][i])
              and np.array_equal(tickets[i].dists, want[1][i]),
              f"scheduled ticket {i} differs from the direct search_batch")
    lat = np.array([tickets[i].latency for i in served])
    log(f"[serving] BatchScheduler (WallClock, slo 250 ms) -> ReplicaSet of "
        f"{rs.n_replicas} replica(s) x {rs.n_shards} shard(s): "
        f"{len(served)} of {len(qs)} queries served in {t_sched:.2f} s "
        f"({len(served) / t_sched:.0f} queries/s), every row equal to "
        f"search_batch; ticket latency p50 {np.percentile(lat, 50) * 1e3:.1f}"
        f" ms p99 {np.percentile(lat, 99) * 1e3:.1f} ms; "
        f"{st.batches_dispatched - batches0} batches, mean occupancy "
        f"{sched.mean_occupancy:.3f}; shed {st.shed_requests - shed0}; "
        f"deadline misses {st.deadline_misses - miss0}; dispatches per "
        f"replica {rs.dispatches}")
    check(len(served) + st.shed_requests - shed0 == len(qs),
          "scheduler: a request was neither served nor shed")
    filtered_serving(s, rs, qs, k)

    # 5. The shard deployment.
    g = np.random.default_rng(seed + 17)
    cap = icfg.capacity
    sync()
    t0 = time.perf_counter()
    blocks = [s.lti]
    for _ in range(3):
        pts = _mixture(g, data["centers"], shard_points)
        blocks.append(build_lti(pts, icfg, cfg.pq, codebook=s.lti.codebook,
                                device=dev))
    sync()
    t_build = time.perf_counter() - t0
    lti = stack_blocks(blocks, dev)
    del blocks, pts
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[serving] shards 1-3: {3 * shard_points} points built in "
        f"{t_build:.1f} s ({3 * shard_points / t_build:.0f} points/s) with "
        f"shard 0's codebook; stacked LTI of 4 x {cap} rows, live per shard "
        f"{[int(x) for x in (lti.graph.active & ~lti.graph.deleted).view(4, -1).sum(1)]}")

    def live(lt):
        m = lt.graph.active & ~lt.graph.deleted
        slots = torch.nonzero(m)[:, 0]
        return lt.graph.vectors[slots], slots.cpu().numpy()

    def serve_all(lt):
        out_i, out_d, secs = [], [], []
        for b in range(nb):
            q = torch.from_numpy(qs[b * bq:(b + 1) * bq]).to(dev)
            sync()
            t0 = time.perf_counter()
            i, d = search(lt, q)
            sync()
            secs.append(time.perf_counter() - t0)
            out_i.append(i.cpu().numpy())
            out_d.append(d.cpu().numpy())
        return np.concatenate(out_i), np.concatenate(out_d), secs

    search = make_distributed_search(group, icfg, k=k)
    n0 = ops.LAUNCHES["block_topk"]
    ids, dists, secs = serve_all(lti)
    check(ops.LAUNCHES["block_topk"] - n0 == nb or dev.type != "cuda",
          f"block_topk launched {ops.LAUNCHES['block_topk'] - n0} times for "
          f"{nb} distributed searches")
    lv, ls = live(lti)
    recall = _recall(ids, qs, lv, ls, k, dev)
    del lv
    check(recall >= 0.90, f"distributed search recall {recall} < 0.90")
    for b in range(nb):
        q = torch.from_numpy(qs[b * bq:(b + 1) * bq]).to(dev)
        parts_i, parts_d = [], []
        for sh in range(4):
            i_, d_, _, _ = search_lti(shard_block(lti, sh, cap, dev), q, icfg,
                                      k=k, L=L)
            i_ = i_.cpu().numpy()
            parts_i.append(np.where(i_ >= 0, i_ + sh * cap, i_))
            parts_d.append(d_.cpu().numpy())
        fi, fd = np.concatenate(parts_i, 1), np.concatenate(parts_d, 1)
        o = np.argsort(fd, axis=1, kind="stable")[:, :k]
        check(np.array_equal(np.take_along_axis(fi, o, 1),
                             ids[b * bq:(b + 1) * bq])
              and np.array_equal(np.take_along_axis(fd, o, 1),
                                 dists[b * bq:(b + 1) * bq]),
              f"distributed search micro-batch {b} differs from the host "
              "merge of the per-shard searches")
    wide(lti, group, icfg, qs[:bq], cap)
    from_shard = np.bincount(ids[ids >= 0] // cap, minlength=4)
    log(f"[serving] make_distributed_search, 4 shards: {len(qs)} queries, "
        f"ms per micro-batch {[round(t * 1e3, 1) for t in secs]}, one "
        f"block_topk launch each; 5-recall@5 {recall:.4f} over {len(ls)} "
        f"live points of the union; equal to the host's stable merge of the "
        f"per-shard searches; results per shard {from_shard.tolist()}")

    ins = _mixture(g, data["centers"], 4096)
    act0 = int(lti.graph.active.sum())
    insert = make_distributed_insert(group, icfg, per_shard=1024)
    sync()
    t0 = time.perf_counter()
    lti = insert(lti, torch.from_numpy(ins).to(dev))
    sync()
    t_ins = time.perf_counter() - t0
    check(int(lti.graph.active.sum()) - act0 == 4096,
          f"distributed insert added {int(lti.graph.active.sum()) - act0}")
    top1, _ = search(lti, torch.from_numpy(ins[:bq]).to(dev))
    top1 = top1[:, 0].long()
    self_hit = float((lti.graph.vectors[top1.clamp(min=0)] == torch.from_numpy(
        ins[:bq]).to(dev)).all(1).float().mean())
    log(f"[serving] make_distributed_insert of 4096 points (1024 a shard): "
        f"{t_ins:.2f} s; rank-1 self-hit of {bq} of them {self_hit:.4f}")
    check(self_hit >= 0.90, f"inserted points found at rank 1: {self_hit}")

    usable = (lti.graph.active & ~lti.graph.deleted).cpu().numpy()
    dmask = np.zeros(4 * cap, bool)
    for sh in range(4):
        sl = np.nonzero(usable[sh * cap:(sh + 1) * cap])[0]
        dmask[sh * cap + g.choice(sl, len(sl) // 100, replace=False)] = True
    dead = np.nonzero(dmask)[0]
    dead_t = torch.from_numpy(dead).to(dev)
    old = lti.graph.vectors[dead_t].clone()
    act1 = int(lti.graph.active.sum())
    mvecs = _mixture(g, data["centers"], 4096)
    merge = make_distributed_merge(group, icfg, cfg.pq,
                                   insert_chunk=cfg.insert_batch,
                                   block=cfg.merge_block)
    sync()
    t0 = time.perf_counter()
    lti = merge(lti, torch.from_numpy(mvecs).to(dev),
                torch.ones(4096, dtype=torch.bool, device=dev),
                torch.from_numpy(dmask).to(dev))
    sync()
    t_merge = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    refilled = (lti.graph.active[dead_t]
                & (lti.graph.vectors[dead_t] != old).any(1)).cpu().numpy()
    stale = dead[~refilled]
    check(not lti.graph.active[torch.from_numpy(stale).to(dev)].any(),
          "a deleted slot is still active after the distributed merge")
    check(int(lti.graph.active.sum()) == act1 - len(dead) + 4096,
          "distributed merge: live count off")
    ids2, _, secs2 = serve_all(lti)
    check(not np.isin(ids2, stale).any(),
          "a deleted point was returned after the distributed merge")
    lv, ls = live(lti)
    recall2 = _recall(ids2, qs, lv, ls, k, dev)
    del lv
    check(recall2 >= 0.90, f"recall after the distributed merge {recall2}")
    log(f"[serving] make_distributed_merge of 4096 points and {len(dead)} "
        f"deletes (1 % of each shard): {t_merge:.2f} s; {int(refilled.sum())}"
        f" freed slots refilled; no deleted point returned; 5-recall@5 "
        f"{recall2:.4f}; ms per micro-batch "
        f"{[round(t * 1e3, 1) for t in secs2]}")
    del lti
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 6. The serving driver at its defaults, on the card and on the CPU.
    t0 = time.perf_counter()
    summary = serve.main(["--device", dev.type])
    t_drv = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = serve.main(["--device", "cpu"])
    t_cpu = time.perf_counter() - t0
    gap = summary["recall_mean"] - on_cpu["recall_mean"]
    # Its defaults: 4,096 points of dim 32, 1,984 inserts and as many
    # deletes, PQ 8 x 64; the card's recall within 0.01 of the CPU's (the
    # parity rule; both train the same codebook's start).
    check(summary["inserts"] == summary["deletes"] == 1984
          and summary["size"] == 4096 and summary["recall_mean"] >= 0.70,
          f"launch.serve: {summary}")
    log(f"[serving] launch.serve.main at its defaults: {t_drv:.1f} s, "
        f"recall_mean {summary['recall_mean']:.4f}, {summary['merges']} "
        f"merges, size {summary['size']}; on the CPU {t_cpu:.1f} s, "
        f"recall_mean {on_cpu['recall_mean']:.4f}; gap {gap:+.4f}")
    check(abs(gap) <= 0.01, f"launch.serve: card recall "
          f"{summary['recall_mean']} vs CPU {on_cpu['recall_mean']}")

    sync()
    launches = dict(ops.LAUNCHES)
    log(f"[serving] launches {json.dumps(launches)}")
    missing = [n for n in SERVING_KERNELS if not launches[n]]
    check(not missing, f"kernels of the serving path never launched: "
          f"{missing}")
    return launches


def filtered_serving(s, rs, qs, k: int, quota: int = 128) -> None:
    """Filtered traffic through the serving front end on the labelled
    system: a synchronous ``BatchScheduler`` with ``tenant_quota`` takes a
    burst from tenant 1 past its quota (the excess shed, counted by
    tenant and in ``shed_requests``) mixed with tickets of three other
    specs; every served row equals ``search_batch`` under its ticket's
    spec, and each batch holds one spec.  Then ``ReplicaSet.search_batch``
    under a filter equals the system's, with its accounting."""
    from repro_torch.core.graph import FilterSpec
    from repro_torch.serving import BatchScheduler
    specs = [None, FilterSpec(tenant=2), FilterSpec(all_of=(1,)),
             FilterSpec(all_of=(2,), tenant=0)]
    with _knobs(s, tenant_quota=quota, serve_queue_capacity=len(qs)):
        st = s.stats
        shed0, sheds0 = st.shed_requests, dict(st.tenant_sheds)
        batches0 = st.batches_dispatched
        sched = BatchScheduler(s, k=k)
        burst = [sched.submit(q, filter=FilterSpec(tenant=1))
                 for q in qs[:2 * quota]]
        mixed = [(i, sched.submit(qs[i], filter=specs[i % len(specs)]))
                 for i in range(2 * quota, min(len(qs), 2 * quota + 512))]
        depth = sched.pending
        t0 = time.perf_counter()
        n_served = sched.flush()
        t_flush = time.perf_counter() - t0
        n_batches = st.batches_dispatched - batches0
    shed_t1 = st.tenant_sheds.get(1, 0) - sheds0.get(1, 0)
    check(sum(t is None for t in burst) == quota == shed_t1
          and st.shed_requests - shed0 == quota
          and all(t is not None for _, t in mixed),
          f"tenant quota: {shed_t1} of tenant 1's {2 * quota} shed, "
          f"shed_requests +{st.shed_requests - shed0} (quota {quota})")
    tickets = [(i, t) for i, t in enumerate(burst)] + mixed
    by_spec: dict = {}
    for i, t in tickets:
        if t is not None:
            by_spec.setdefault(t.fspec, []).append((i, t))
    check(n_batches == len(by_spec) and n_served == len(tickets) - quota,
          f"{n_batches} batches for {len(by_spec)} specs, {n_served} served")
    for spec, group in by_spec.items():
        idx = np.array([i for i, _ in group])
        want = s.search_batch(qs[idx], k=k, filter=spec)
        for j, (_, t) in enumerate(group):
            check(np.array_equal(t.ids, want[0][j])
                  and np.array_equal(t.dists, want[1][j]),
                  f"scheduled ticket under {spec} differs from search_batch")
    log(f"[serving] BatchScheduler with tenant_quota {quota}: a burst of "
        f"{2 * quota} from tenant 1 (shed {shed_t1}, tenant_sheds "
        f"{dict(st.tenant_sheds)}) and {len(mixed)} tickets of "
        f"{len(specs)} specs; "
        f"queue {depth}, {n_served} served in {n_batches} one-spec batches "
        f"in {t_flush * 1e3:.1f} ms, every row equal to search_batch under "
        f"its spec")
    spec = FilterSpec(tenant=2)
    f0, d0 = s.stats.filtered_searches, sum(rs.dispatches)
    got = rs.search_batch(qs, k=k, filter=spec)
    want = s.search_batch(qs, k=k, filter=spec)
    check(all(np.array_equal(a, b) for a, b in zip(got, want))
          and s.stats.filtered_searches - f0 == 2 * len(qs)
          and sum(rs.dispatches) - d0 == -(-len(qs) // s.cfg.batch_queries),
          "ReplicaSet.search_batch under a filter differs from the system's")
    log(f"[serving] ReplicaSet.search_batch(filter=tenant 2): {len(qs)} "
        f"queries equal to search_batch; dispatches per replica "
        f"{rs.dispatches}")


def wide(lti, group, icfg, qs, cap, k: int = 129, L: int = 160) -> None:
    """``make_distributed_search`` at k 129, past ``block_topk``'s 128 (its
    merge a stable device sort, no ``block_topk`` launch), equal to the
    per-shard ``search_lti``s merged on the host by a stable sort, with
    id -1 at every non-finite pick."""
    import torch
    from repro_torch.core.lti import search_lti
    from repro_torch.kernels import ops
    from repro_torch.launch.ann_steps import (make_distributed_search,
                                              shard_block)
    dev = group[0]
    q = torch.from_numpy(qs).to(dev)
    n0 = ops.LAUNCHES["block_topk"]
    t0 = time.perf_counter()
    ids, dists = make_distributed_search(group, icfg, k=k, L=L)(lti, q)
    ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
    secs = time.perf_counter() - t0
    parts_i, parts_d = [], []
    for sh in range(len(group)):
        i_, d_, _, _ = search_lti(shard_block(lti, sh, cap, dev), q, icfg,
                                  k=k, L=L)
        i_ = i_.cpu().numpy()
        parts_i.append(np.where(i_ >= 0, i_ + sh * cap, i_))
        parts_d.append(d_.cpu().numpy())
    fi, fd = np.concatenate(parts_i, 1), np.concatenate(parts_d, 1)
    o = np.argsort(fd, axis=1, kind="stable")[:, :k]
    want_d = np.take_along_axis(fd, o, 1)
    want_i = np.where(np.isfinite(want_d), np.take_along_axis(fi, o, 1), -1)
    check(ids.shape == (len(qs), k) and np.array_equal(ids, want_i)
          and np.array_equal(dists, want_d),
          f"distributed search at k {k} differs from the host's stable "
          "merge of the per-shard searches")
    check(ops.LAUNCHES["block_topk"] == n0,
          f"distributed search at k {k} launched block_topk")
    log(f"[serving] make_distributed_search at k {k}, L {L}: {len(qs)} "
        f"queries in {secs * 1e3:.1f} ms, equal to the host's stable merge "
        f"(stable device sort, no block_topk launch); "
        f"{int((ids < 0).sum())} ids -1")


def profile_run(name: str, fn) -> None:
    """Run ``fn()`` once under torch.profiler and log its wall time, the
    device's busy and idle shares, and device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {name}: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms ({busy / wall:.1%}), idle "
        f"{1 - busy / wall:.1%}; top device time: " + "; ".join(
            f"{k[:48]} {v / 1e3:.2f} ms" for k, v in top))


def profile_steps(s, queries, vecs, merge_vecs, first_id) -> None:
    """Device busy share and kernel time by name, from torch.profiler,
    over one search micro-batch, one flush and one StreamingMerge (a
    local Delete phase of 1 % deletes and len(merge_vecs) points, on the
    LTI, not swapped in) after the main path."""
    import torch
    from repro_torch.core.merge import streaming_merge
    run = profile_run

    def flush():
        for i, v in enumerate(vecs):
            s.insert(first_id + i, v)
        s._flush_inserts()

    lti = s.lti
    dev = lti.graph.device
    rng = np.random.default_rng(5)
    live = torch.nonzero(lti.graph.active)[:, 0].cpu().numpy()
    dmask = torch.zeros_like(lti.graph.active)
    dmask[torch.from_numpy(rng.choice(live, len(live) // 100,
                                      replace=False)).to(dev)] = True
    timings: dict = {}

    def merge():
        streaming_merge(lti, torch.from_numpy(merge_vecs).to(dev),
                        torch.ones(len(merge_vecs), dtype=torch.bool,
                                   device=dev), dmask, s.cfg.index,
                        s.cfg.pq, insert_chunk=s.cfg.insert_batch,
                        block=s.cfg.merge_block, repair_mode="local",
                        timings=timings)

    run(f"search_batch {len(queries)} queries",
        lambda: s.search_batch(queries, k=5))
    run(f"flush of {len(vecs)} inserts", flush)
    run(f"streaming_merge of {len(merge_vecs)} points, 1 % deletes, local "
        "Delete phase", merge)
    log(f"[profile] that merge by phase: {_fmt_phases(timings)}")


# --------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_048_576,
                    help="bootstrap points of the main path")
    ap.add_argument("--centres", type=int, default=4096,
                    help="Gaussian centres of the main path's corpus")
    ap.add_argument("--phases",
                    default="build,kernels,parity,recsys,main,filtered,"
                    "storage,serving")
    ap.add_argument("--src", default=None,
                    help="import the port from this src directory instead "
                    "(another checkout; with --phases build,launch)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    recs = {}
    try:
        if "build" in phases:
            phase_build()
        ident = gpu_identity()
        log(f"[device] {ident}")
        if "kernels" in phases:
            recs = phase_kernels(args.seed, n_table=args.n)
            recs.update(topk_kernel_record(args.seed))
        if "launch" in phases:
            phase_launch(args.seed, n_table=args.n)
        if "parity" in phases:
            phase_parity(args.seed)
        if "recsys" in phases:
            figures, readings = phase_recsys(args.seed)
            log(f"[recsys] figures {json.dumps(figures)}")
            for name, entries in readings.items():
                if name in recs:
                    recs[name].setdefault("by_shape", []).extend(entries)
        if "main" in phases:
            with shape_census() as census:
                launches, s, data = phase_main(args.seed, args.n,
                                               args.centres)
            for name, by_shape in census.items():
                log(f"[main] {name} launches by shape: "
                    f"{json.dumps(by_shape)}")
                check(sum(by_shape.values()) == launches[name],
                      f"{name}: the census counts {by_shape}, the wrapper "
                      f"{launches[name]}")
            if "kernels" in phases:
                recs.update(repair_kernel_records(s.lti, args.seed))
                recs.update(gather_kernel_record(s.lti, args.seed))
                for name, by_shape in census.items():
                    recs[name]["launches_by_shape"] = by_shape
            if "filtered" in phases:
                _, census = phase_filtered(s, data, args.seed)
                if "frontier_select" in recs:
                    recs["frontier_select"]["filtered_launches_by_shape"] = (
                        census)
            if "storage" in phases:
                st_launches = phase_storage(s, data, args.seed,
                                            profile="profile" in phases)
                launches["gather_rows"] = st_launches["gather_rows"]
            if "serving" in phases:
                sv_launches = phase_serving(s, data, args.seed)
                launches["block_topk"] = sv_launches["block_topk"]
            for name, cnt in launches.items():
                if name in recs:
                    recs[name]["launches"] = cnt
            if {"kernels", "storage", "serving"} <= phases:
                check(len(recs) == len(KERNEL_META) and all(
                    r["launches"] > 0 for r in recs.values()),
                    "a kernel record without launches on its path")
            if "profile" in phases:
                g = np.random.default_rng(args.seed + 3)
                pts = (g.standard_normal((4096 + 256, 128)) * 2.0).astype(
                    np.float32)
                profile_steps(s, pts[:1024], pts[4096:], pts[:4096],
                              10 * args.n)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(ident)
    print(json.dumps({"kernels": [recs[k] for k in KERNEL_META
                                  if k in recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
