"""End-to-end serving run on the PyTorch port: sustained concurrent
insert/delete/search stream against a FreshDiskANN system with threshold
merges -- the paper's §6.2 steady-state experiment at a small scale.

    PYTHONPATH=src python examples/torch_serve_ann.py --minutes 0.5 \\
        [--device cpu]

It runs on the card unless ``--device cpu`` asks for the CPU (the kernels'
plain versions).  Every search batch rides the unified fan-out: the RW
tier, all frozen RO snapshots and the PQ-navigated LTI lane as one
program per micro-batch (``disp/batch`` stays at 1.0 however many tiers
are live).  ``--split-fanout`` switches to the sequential per-tier oracle
(the same results, one program per tier).  ``--batch-queries N`` serves
requests in fixed-shape micro-batches of N; ``--shard-lti N`` row-shards
the LTI lane over a group of N devices (``distributed/sharding.py``:
``cuda:0`` ... ``cuda:N-1``, capped at the card count; on the CPU N
shards of the host); ``--autotune-beam`` lets the system pick the beam
width W by probing the unified program.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.config import IndexConfig, PQConfig, SystemConfig
from repro_torch.core.index import brute_force, recall_at_k
from repro_torch.core.system import bootstrap_system
from repro_torch.data.pipelines import vector_stream

DIM = 32


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=0.5)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--split-fanout", action="store_true",
                    help="sequential per-tier search loop (the oracle) "
                         "instead of the one-program unified fan-out")
    ap.add_argument("--autotune-beam", action="store_true",
                    help="calibrate the beam width W against the unified "
                         "fan-out program instead of using the static W")
    ap.add_argument("--batch-queries", type=int, default=0,
                    help="fixed serving micro-batch width (0 = natural "
                         "request shape); search_dispatches counts "
                         "ceil(B/N) programs per request")
    ap.add_argument("--shard-lti", type=int, default=0,
                    help="row-shard the LTI lane over this many devices "
                         "(capped at the card count; 0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    n = args.points

    corpus = next(vector_stream(n, DIM, seed=1))
    cfg = SystemConfig(
        index=IndexConfig(capacity=8 * n, dim=DIM, R=24, L_build=32,
                          L_search=48, alpha=1.2),
        pq=PQConfig(dim=DIM, m=8, ksub=64, kmeans_iters=6),
        ro_snapshot_points=n // 8, merge_threshold=n // 4,
        temp_capacity=n, insert_batch=64,
        batch_fanout=not args.split_fanout,
        autotune_beam=args.autotune_beam,
        batch_queries=args.batch_queries, shard_lti=args.shard_lti)
    system = bootstrap_system(corpus, np.arange(n), cfg, device=args.device)
    dev = system.device
    live = dict(enumerate(corpus))
    upd = vector_stream(64, DIM, seed=7)
    qs = vector_stream(16, DIM, seed=9)
    rng = np.random.default_rng(0)

    next_id = n
    t_start = time.time()
    deadline = t_start + args.minutes * 60
    ins_lat, recalls = [], []
    cycle = searches = 0
    while time.time() < deadline:
        batch = next(upd)
        for v in batch:                      # steady state: equal in/out
            t = time.perf_counter()
            system.insert(next_id, v)
            ins_lat.append(time.perf_counter() - t)
            live[next_id] = v
            next_id += 1
        victims = rng.choice(sorted(live), 64, replace=False)
        for e in victims:
            system.delete(int(e))
            live.pop(int(e))
        cycle += 1
        if cycle % 4 == 0:
            q = next(qs)
            t = time.perf_counter()
            ids, _ = system.search_batch(q, k=5)
            s_lat = time.perf_counter() - t
            searches += 1
            keys = np.asarray(sorted(live))
            mat = torch.from_numpy(np.stack([live[k] for k in keys])).to(dev)
            gt = brute_force(mat, torch.ones(len(keys), dtype=torch.bool,
                                             device=dev),
                             torch.from_numpy(q).to(dev), 5)
            rec = recall_at_k(torch.from_numpy(ids),
                              torch.from_numpy(keys[gt.cpu().numpy()]))
            recalls.append(rec)
            print(f"[steady-state] t={time.time() - t_start:5.0f}s "
                  f"size={system.size} recall@5={rec:.3f} "
                  f"search={s_lat * 1e3:.0f}ms "
                  f"disp/batch={system.stats.search_dispatches / searches:.1f} "
                  f"ins_p50={np.median(ins_lat) * 1e3:.1f}ms "
                  f"merges={system.stats.merges}")
    mode = "split" if args.split_fanout else "unified"
    if system.lti_shards:
        mode += f" x {system.lti_shards}-shard LTI lane"
    print(f"final: mean recall {np.mean(recalls) if recalls else float('nan'):.3f}, "
          f"{system.stats.inserts} inserts, {system.stats.deletes} deletes, "
          f"{system.stats.merges} merges, {mode} fan-out on {dev}: "
          f"{system.stats.search_dispatches / max(searches, 1):.1f} "
          f"device programs per search batch")


if __name__ == "__main__":
    main()
