"""The paper's integration on the PyTorch port: a SASRec sequential
recommender whose candidate retrieval runs through a *streaming*
FreshDiskANN index of item embeddings.

New items are inserted into the index online; retired items are deleted;
the recommender's query vector (the encoder's final hidden state) searches
the fresh index -- the fresh-ANNS problem the paper solves.  Compares ANN
retrieval against exact scoring over the live catalog.

    PYTHONPATH=src python examples/torch_sasrec_retrieval.py [--device cpu]

It runs on the card unless ``--device cpu`` asks for the CPU (the
kernels' plain versions).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.config import (IndexConfig, PQConfig, SystemConfig,
                                     resolve_device)
from repro_torch.core.system import bootstrap_system
from repro_torch.data.pipelines import sasrec_stream
from repro_torch.launch.train import module_loss
from repro_torch.models import recsys as rec
from repro_torch.optim.adamw import adamw_init
from repro_torch.training.steps import make_train_step
from repro_torch.tree import module_tree, tree_leaves, tree_paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch("sasrec").smoke_config
    n_items = cfg.n_items
    model = rec.init_recsys_params(torch.Generator().manual_seed(0), cfg,
                                   device)

    # --- 1. train SASRec briefly on the synthetic interaction stream -----
    def bpr(m, b):
        loss = rec.sasrec_loss(m, b["seq"], b["pos"], b["neg"], cfg)
        return loss, {}

    step = make_train_step(module_loss(model, bpr), lr=5e-3,
                           weight_decay=0.0)
    params = module_tree(model)
    opt = adamw_init(params)
    stream = sasrec_stream(64, cfg.seq_len, n_items, seed=2)
    for _ in range(40):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in next(stream).items()}
        params, opt, metrics = step(params, opt, b)
    print(f"[sasrec] trained 40 steps, BPR loss "
          f"{float(metrics['loss']):.4f}")

    # --- 2. index the item embeddings in FreshDiskANN --------------------
    items = params["item_emb"].cpu().numpy()
    # cosine/IP retrieval -> L2 on normalized vectors (paper: "identical
    # when the data is normalized")
    norm = items / np.maximum(np.linalg.norm(items, axis=1, keepdims=True),
                              1e-6)
    scfg = SystemConfig(
        index=IndexConfig(capacity=4 * n_items, dim=cfg.embed_dim, R=24,
                          L_build=32, L_search=64, alpha=1.2),
        pq=PQConfig(dim=cfg.embed_dim, m=8, ksub=32, kmeans_iters=4),
        ro_snapshot_points=128, merge_threshold=256,
        temp_capacity=1024, insert_batch=64)
    index = bootstrap_system(norm[1:], np.arange(1, n_items), scfg,
                             device=device)
    print(f"[sasrec] indexed {n_items - 1} items on {index.device}")

    # --- 3. streaming catalog updates: new items in, retired items out ---
    rng = np.random.default_rng(5)
    new_vecs = rng.standard_normal((64, cfg.embed_dim)).astype(np.float32)
    new_vecs /= np.linalg.norm(new_vecs, axis=1, keepdims=True)
    for i, v in enumerate(new_vecs):
        index.insert(n_items + i, v)
    retired = rng.choice(np.arange(1, n_items), 64, replace=False)
    for e in retired:
        index.delete(int(e))
    print(f"[sasrec] +64 new items, -64 retired (live size {index.size})")

    # --- 4. retrieval: encoder query -> fresh index -----------------------
    with torch.no_grad():
        hidden = torch.func.functional_call(
            model, dict(zip(tree_paths(params), tree_leaves(params))),
            (b["seq"][:8],))
    qv = hidden[:, -1].cpu().numpy()
    qv = qv / np.maximum(np.linalg.norm(qv, axis=1, keepdims=True), 1e-6)
    ann_ids, _ = index.search(qv, k=10)

    # exact baseline over the live catalog (incl. new, excl. retired)
    old_live = np.setdiff1d(np.arange(1, n_items), retired)
    live = np.concatenate([old_live, np.arange(n_items, n_items + 64)])
    table = np.concatenate([norm[old_live], new_vecs])
    _, top = rec.retrieval_topk(torch.from_numpy(qv),
                                torch.from_numpy(table), 10)
    exact = live[top.numpy()]

    inter = np.mean([len(set(a.tolist()) & set(e.tolist())) / 10
                     for a, e in zip(np.asarray(ann_ids), exact)])
    print(f"[sasrec] ANN-vs-exact top-10 overlap: {inter:.2f}")
    print(f"[sasrec] retired items absent from results: "
          f"{not np.isin(np.asarray(ann_ids), retired).any()}")


if __name__ == "__main__":
    main()
