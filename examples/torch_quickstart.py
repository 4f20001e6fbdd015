"""Quickstart on the PyTorch port: build a FreshDiskANN system, stream
updates, search.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the card unless ``--device cpu`` asks for the CPU (the
kernels' plain versions).
"""
import argparse

import numpy as np
import torch

from repro_torch.core.config import IndexConfig, PQConfig, SystemConfig
from repro_torch.core.index import brute_force, recall_at_k
from repro_torch.core.system import bootstrap_system
from repro_torch.data.pipelines import vector_stream

DIM, N = 32, 2048


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    # 1. A corpus of vectors (any embedding source works the same way).
    stream = vector_stream(N, DIM, seed=1)
    corpus = next(stream)

    # 2. Bootstrap: static DiskANN-style build of the Long-Term Index.
    cfg = SystemConfig(
        index=IndexConfig(capacity=4 * N, dim=DIM, R=24, L_build=32,
                          L_search=72, alpha=1.2),
        pq=PQConfig(dim=DIM, m=8, ksub=64, kmeans_iters=6),
        ro_snapshot_points=256, merge_threshold=512,
        temp_capacity=1024, insert_batch=64)
    system = bootstrap_system(corpus, np.arange(N), cfg, device=args.device)
    print(f"bootstrapped {N} points on {system.device}")

    # 3. Live updates: inserts go to the in-memory TempIndex, deletes to
    #    the DeleteList (instant).  A StreamingMerge folds them into the
    #    LTI when enough accumulate.
    fresh = next(vector_stream(512, DIM, seed=2))
    for i, v in enumerate(fresh):
        system.insert(N + i, v)
    for ext_id in range(0, 200):
        system.delete(ext_id)
    print(f"after updates: size={system.size} merges={system.stats.merges}")

    # 4. Search spans LTI + TempIndex and filters deleted ids.
    queries = next(vector_stream(16, DIM, seed=3))
    ids, dists = system.search(queries, k=5)
    print("top-5 ids for query 0:", ids[0])

    # 5. Verify against exact ground truth over the live set.
    dev = system.device
    live_ids = np.array([e for e in range(N + 512)
                         if e >= 200 and (e < N or e - N < 512)])
    live_vecs = np.concatenate([corpus[200:], fresh])
    gt = brute_force(torch.from_numpy(live_vecs).to(dev),
                     torch.ones(len(live_vecs), dtype=torch.bool,
                                device=dev),
                     torch.from_numpy(queries).to(dev), 5)
    gt_ext = live_ids[gt.cpu().numpy()]
    print(f"5-recall@5 vs brute force: "
          f"{recall_at_k(torch.from_numpy(ids), torch.from_numpy(gt_ext)):.3f}")


if __name__ == "__main__":
    main()
