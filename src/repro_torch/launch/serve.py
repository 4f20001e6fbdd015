"""Serving driver for the FreshDiskANN system (the paper's workload), the
PyTorch port of ``launch/serve.py``: bootstraps an index, then runs a
stream of inserts, deletes and searches with threshold StreamingMerges,
reporting recall and latencies.

    PYTHONPATH=src python -m repro_torch.launch.serve --points 4096 \\
        --dim 32 --updates 2000 --searches 20 [--device cpu]

It runs on the card unless ``--device cpu`` asks for the CPU (a rehearsal
with the kernels' plain versions).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.config import IndexConfig, PQConfig, SystemConfig
from ..core.index import brute_force, recall_at_k
from ..core.system import bootstrap_system
from ..data.pipelines import vector_stream


def main(argv=None) -> dict:
    """Run the driver; returns the final summary it prints last."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--updates", type=int, default=2000)
    ap.add_argument("--searches", type=int, default=20)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--wal-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    stream = vector_stream(args.points, args.dim, seed=3)
    base = next(stream)
    cfg = SystemConfig(
        index=IndexConfig(capacity=args.points * 4, dim=args.dim, R=24,
                          L_build=32, L_search=48, alpha=1.2),
        pq=PQConfig(dim=args.dim, m=8, ksub=64, kmeans_iters=6),
        ro_snapshot_points=args.points // 4,
        merge_threshold=args.points // 2,
        temp_capacity=args.points, insert_batch=64, wal_dir=args.wal_dir)
    t0 = time.perf_counter()
    sys_ = bootstrap_system(base, np.arange(args.points), cfg,
                            device=args.device)
    dev = sys_.device
    print(f"[serve] bootstrap {args.points} pts in "
          f"{time.perf_counter() - t0:.1f}s on {dev}")

    upd = vector_stream(64, args.dim, seed=11)
    q_stream = vector_stream(32, args.dim, seed=13)
    next_id = args.points
    live = dict(enumerate(np.asarray(base)))
    ins_lat, del_lat, search_recalls = [], [], []
    rng = np.random.default_rng(0)

    for i in range(args.updates // 64):
        batch = next(upd)
        for v in batch:
            t = time.perf_counter()
            sys_.insert(next_id, v)
            ins_lat.append(time.perf_counter() - t)
            live[next_id] = v
            next_id += 1
        # Delete as many random existing points.
        victims = rng.choice(sorted(live), size=min(64, len(live) - 64),
                             replace=False)
        for ext in victims:
            t = time.perf_counter()
            sys_.delete(int(ext))
            del_lat.append(time.perf_counter() - t)
            live.pop(int(ext))
        if (i + 1) % 4 == 0:
            q = next(q_stream)
            ids, _ = sys_.search(q, k=args.k)
            keys = np.asarray(sorted(live))
            mat = torch.from_numpy(np.stack([live[k] for k in keys])).to(dev)
            gt = brute_force(mat, torch.ones(len(keys), dtype=torch.bool,
                                             device=dev),
                             torch.from_numpy(q).to(dev), args.k)
            gt_ext = keys[gt.cpu().numpy()]
            rec = recall_at_k(torch.from_numpy(ids),
                              torch.from_numpy(gt_ext))
            search_recalls.append(rec)
            print(f"[serve] step {i + 1}: size={sys_.size} "
                  f"recall@{args.k}={rec:.3f} "
                  f"ins_p50={np.median(ins_lat) * 1e3:.2f}ms "
                  f"merges={sys_.stats.merges}")

    summary = dict(recall_mean=float(np.mean(search_recalls)),
                   recalls=search_recalls, size=sys_.size,
                   inserts=sys_.stats.inserts, deletes=sys_.stats.deletes,
                   merges=sys_.stats.merges)
    print(f"[serve] final: recall_mean={summary['recall_mean']:.3f} "
          f"inserts={sys_.stats.inserts} deletes={sys_.stats.deletes} "
          f"merges={sys_.stats.merges} "
          f"ins_p50={np.median(ins_lat) * 1e3:.2f}ms "
          f"del_p50={np.median(del_lat) * 1e6:.1f}us")
    if sys_.wal:
        sys_.wal.close()
    return summary


if __name__ == "__main__":
    main()
