"""Training driver, the PyTorch port of ``launch/train.py``: ``--arch <id>``
picks a config and trains its smoke config, the only one this script
trains (so the reference's ``--smoke`` flag has no counterpart), with
AdamW through the fault-tolerant loop (checkpoint/restart via
``--ckpt-dir``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt [--device cpu]

Families: ``lm`` (the dense decoder LMs; a MoE arch raises
``NotImplementedError`` at its first step), ``recsys`` (FM, DeepFM,
xDeepFM, SASRec) and ``gnn`` (GraphSAGE, sampled, on a 512-node synthetic
graph).  It runs on the card unless ``--device cpu`` asks for the CPU.
Weights are drawn from torch generators seeded with 0 (on the card for an
LM, on the CPU otherwise); the gnn stream's per-step ``jax.random`` key
is the step number as the seed of the sampler's CPU generator.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
from torch import nn

from ..configs import get_arch
from ..core.config import resolve_device
from ..data.pipelines import (click_stream, lm_token_stream, sasrec_stream,
                              synthetic_graph)
from ..optim.adamw import adamw_init
from ..training.loop import run_training
from ..training.steps import make_train_step
from ..tree import module_tree, tree_leaves, tree_paths


class _Loss(nn.Module):
    """A model and a loss of (model, batch), for ``functional_call``."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, batch):
        return self.fn(self.model, batch)


def module_loss(model: nn.Module, fn):
    """loss_fn(params tree, batch) running ``fn(model, batch)`` with the
    tree's tensors in place of the model's parameters."""
    wrapped = _Loss(model, fn)

    def loss_fn(p, b):
        named = {f"model.{k}": v
                 for k, v in zip(tree_paths(p), tree_leaves(p))}
        return torch.func.functional_call(wrapped, named, (b,))

    return loss_fn


def build_smoke_trainer(arch_name: str, batch: int, seq: int, lr: float,
                        accum: int = 1, device="cuda"):
    """(params, train_step, stream) of ``arch_name``'s smoke config."""
    device = resolve_device(device)
    arch = get_arch(arch_name)
    cfg = arch.smoke_config
    cpu_gen = torch.Generator().manual_seed(0)

    if arch.family == "lm":
        from ..models import transformer as tf
        cfg = dataclasses.replace(cfg, q_chunk=min(cfg.q_chunk, seq),
                                  kv_chunk=min(cfg.kv_chunk, seq))
        gen = torch.Generator(device=device).manual_seed(0)
        params = tf.init_params(cfg, gen, device)

        def loss_fn(p, b):
            return tf.lm_loss(p, b["tokens"], b["targets"], cfg)

        def stream(s):
            return lm_token_stream(batch, seq, cfg.vocab, start_step=s)
    elif arch.family == "recsys":
        from ..models import recsys as rec
        model = rec.init_recsys_params(cpu_gen, cfg, device)
        params = module_tree(model)
        if cfg.kind == "sasrec":
            def fn(m, b):
                loss = rec.sasrec_loss(m, b["seq"], b["pos"], b["neg"], cfg)
                return loss, {"bpr": loss}

            def stream(s):
                return sasrec_stream(batch, cfg.seq_len, cfg.n_items,
                                     start_step=s)
        else:
            def fn(m, b):
                loss = rec.recsys_loss(m, b["ids"], b["labels"], cfg)
                return loss, {"logloss": loss}

            def stream(s):
                return click_stream(batch, cfg.n_sparse, cfg.rows_per_field,
                                    start_step=s)
        loss_fn = module_loss(model, fn)
    elif arch.family == "gnn":
        from ..models import gnn
        params = gnn.init_sage_params(cfg, cpu_gen, device)
        g = synthetic_graph(512, 8, cfg.d_feat, cfg.n_classes)
        feats, offsets, nbrs = (torch.from_numpy(g[k]).to(device)
                                for k in ("feats", "offsets", "nbrs"))

        def loss_fn(p, b):
            loss = gnn.sage_loss_sampled(p, b["seed"], feats, offsets, nbrs,
                                         b["seeds"], b["labels"], cfg)
            return loss, {"ce": loss}

        def stream(s):
            step = s
            while True:
                r = np.random.default_rng([7, step])
                seeds = r.integers(0, 512, batch)
                yield {"seeds": seeds.astype(np.int32),
                       "labels": g["labels"][seeds], "seed": step}
                step += 1
    else:
        raise ValueError(arch.family)

    step = make_train_step(loss_fn, lr=lr, accum_steps=accum)
    return params, step, stream


def main(argv=None):
    """Train; returns (params, opt_state, metrics log)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    params, step, stream = build_smoke_trainer(
        args.arch, args.batch, args.seq, args.lr, args.accum, args.device)
    opt = adamw_init(params)
    params, opt, log = run_training(
        args.device, step, params, opt, stream, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=args.log_every)
    print(f"[train] done: final metrics {log[-1] if log else {}}")
    return params, opt, log


if __name__ == "__main__":
    main()
