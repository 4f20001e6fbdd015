"""Training driver, the PyTorch port of ``launch/train.py``: ``--arch <id>``
picks a config and trains its smoke config, the only one this script
trains (so the reference's ``--smoke`` flag has no counterpart), with
AdamW through the fault-tolerant loop (checkpoint/restart via
``--ckpt-dir``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt [--device cpu]

Families: ``lm`` (the decoder LMs, dense and MoE), ``recsys`` (FM,
DeepFM, xDeepFM, SASRec) and ``gnn`` (GraphSAGE, sampled, on a 512-node
synthetic graph).  It runs on the card unless ``--device cpu`` asks for
the CPU.  Weights are drawn from torch generators seeded with 0 (on the
card for an LM, on the CPU otherwise); the gnn stream's per-step
``jax.random`` key is the step number as the seed of the sampler's CPU
generator.

``main`` builds ``host_mesh()`` on ``--device`` (every card as data
rows; one card is a 1 x 1 mesh), shards the parameters by the family's
rule (``param_shardings``: ``fsdp_rule`` for an LM, the big tables
row-sharded for recsys, generic for gnn), runs the mesh's data-parallel
step (it enters ``activation_sharding(mesh)`` itself) and restores a
checkpoint onto the same shardings, as the reference's ``main`` wraps its
step in ``activation_sharding(mesh)``.  ``main(argv, mesh=...)`` takes
another mesh, e.g. ``host_mesh(model=2, devices=[cuda:0] * 4)``.

``build_cell_trainer`` builds the full configs' trainers at their
``train`` cells (lm ``train_4k``, recsys ``train_batch``), which
``chip_smoke.py``'s train phase steps on the card.
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
from ..distributed.ctx import whole
from ..distributed.sharding import (generic_param_shardings, host_mesh,
                                    is_sharded, lm_param_shardings,
                                    place_tree, shardings_of)
from ..optim.adamw import adamw_init
from ..training.loop import run_training
from ..training.steps import make_train_step
from ..tree import module_tree, tree_leaves, tree_map, tree_paths

# The recsys tables the reference row-shards (``launch/build.py``).
RECSYS_TABLES = ("V", "w_lin", "item_emb")


class _Loss(nn.Module):
    """A model and a loss of (model, batch), for ``functional_call``."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, batch):
        return self.fn(self.model, batch)


def module_loss(model: nn.Module, fn):
    """loss_fn(params tree, batch) running ``fn(model, batch)`` with the
    tree's tensors in place of the model's parameters (a sharded leaf
    gathered whole where it computes, ``distributed.ctx.whole``)."""
    wrapped = _Loss(model, fn)

    def loss_fn(p, b):
        named = {f"model.{k}": whole(v)
                 for k, v in zip(tree_paths(p, is_leaf=is_sharded),
                                 tree_leaves(p, is_leaf=is_sharded))}
        return torch.func.functional_call(wrapped, named, (b,))

    return loss_fn


def train_loss(family: str, cfg):
    """loss_fn(params tree, batch) -> (loss, metrics) of an ``lm`` or
    ``recsys`` config, the reference's training losses: ``lm_loss`` (ce,
    aux), ``recsys_loss`` ("logloss"), ``sasrec_loss`` ("bpr").  It runs
    on the device of the tensors it is given (a recsys model's module
    lives on the meta device and only names the parameters)."""
    if family == "lm":
        from ..models import transformer as tf

        def loss_fn(p, b):
            return tf.lm_loss(p, b["tokens"], b["targets"], cfg)
        return loss_fn
    if family != "recsys":
        raise ValueError(family)
    from ..models import recsys as rec
    with torch.device("meta"):
        model = rec.make_model(cfg)
    if cfg.kind == "sasrec":
        def fn(m, b):
            loss = rec.sasrec_loss(m, b["seq"], b["pos"], b["neg"], cfg)
            return loss, {"bpr": loss}
    else:
        def fn(m, b):
            loss = rec.recsys_loss(m, b["ids"], b["labels"], cfg)
            return loss, {"logloss": loss}
    return module_loss(model, fn)


def param_shardings(family: str, mesh, params):
    """The family's rule a leaf of ``params``: ``lm_param_shardings`` for
    an LM, ``generic_param_shardings`` with ``RECSYS_TABLES`` for recsys,
    without tables for gnn."""
    if family == "lm":
        return lm_param_shardings(mesh, params)
    tables = RECSYS_TABLES if family == "recsys" else ()
    return generic_param_shardings(mesh, params, table_names=tables)


def build_trainer(family: str, cfg, batch: int, seq: int, *,
                  lr: float = 3e-4, accum_steps: int = 1, device="cuda",
                  seed: int = 0, mesh=None):
    """(params, train_step, stream) of ``cfg``, a config of ``family``
    (``lm``, ``recsys`` or ``gnn``): weights drawn from ``seed`` (an LM's
    on a generator on ``device``, the others' on a CPU generator),
    ``make_train_step`` at ``lr`` and the reference's weight decay 0.1
    and clip 1.0 (over ``mesh`` when given), and ``stream(start_step)``,
    the family's synthetic batches of ``batch`` rows (an LM's of ``seq``
    tokens; the gnn family's seeds on a 512-node synthetic graph)."""
    device = resolve_device(device)
    cpu_gen = torch.Generator().manual_seed(seed)

    if family == "lm":
        from ..models import transformer as tf
        cfg = dataclasses.replace(cfg, q_chunk=min(cfg.q_chunk, seq),
                                  kv_chunk=min(cfg.kv_chunk, seq))
        gen = torch.Generator(device=device).manual_seed(seed)
        params = tf.init_params(cfg, gen, device)
        loss_fn = train_loss(family, cfg)

        def stream(s):
            return lm_token_stream(batch, seq, cfg.vocab, start_step=s)
    elif family == "recsys":
        from ..models import recsys as rec
        params = module_tree(rec.init_recsys_params(cpu_gen, cfg, device))
        loss_fn = train_loss(family, cfg)
        if cfg.kind == "sasrec":
            def stream(s):
                return sasrec_stream(batch, cfg.seq_len, cfg.n_items,
                                     start_step=s)
        else:
            def stream(s):
                return click_stream(batch, cfg.n_sparse, cfg.rows_per_field,
                                    start_step=s)
    elif family == "gnn":
        from ..models import gnn
        params = gnn.init_sage_params(cfg, cpu_gen, device)
        g = synthetic_graph(512, 8, cfg.d_feat, cfg.n_classes)
        feats, offsets, nbrs = (torch.from_numpy(g[k]).to(device)
                                for k in ("feats", "offsets", "nbrs"))

        def loss_fn(p, b):
            p = tree_map(whole, p, is_leaf=is_sharded)
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
        raise ValueError(family)

    step = make_train_step(loss_fn, lr=lr, accum_steps=accum_steps,
                           mesh=mesh)
    return params, step, stream


def build_smoke_trainer(arch_name: str, batch: int, seq: int, lr: float,
                        accum: int = 1, device="cuda", mesh=None):
    """(params, train_step, stream) of ``arch_name``'s smoke config."""
    arch = get_arch(arch_name)
    return build_trainer(arch.family, arch.smoke_config, batch, seq, lr=lr,
                         accum_steps=accum, device=device, mesh=mesh)


def build_cell_trainer(arch_name: str, shape: str, *, accum_steps: int = 1,
                       n_layers: int | None = None, device="cuda",
                       seed: int = 0):
    """(params, train_step, stream) of ``arch_name``'s FULL config at its
    cell ``shape`` of kind ``train`` (lm ``train_4k``: B 256 x S 4,096;
    recsys ``train_batch``: B 65,536): the ``train`` branches of the
    reference's ``launch/build.py`` (``_build_lm``, ``_build_recsys``)
    without their shardings, at ``make_train_step``'s defaults (lr 3e-4,
    weight decay 0.1, clip 1.0).  ``accum_steps`` splits the batch into
    microbatches (the reference takes 2 above 5e9 parameters, for its
    mesh; one card takes as many as its memory needs); ``n_layers`` cuts
    an LM's depth.  Weights are drawn from ``seed``."""
    arch = get_arch(arch_name)
    cell = arch.cell(shape)
    if arch.family not in ("lm", "recsys") or cell.kind != "train":
        raise ValueError(f"{arch_name} {shape}: not an lm or recsys train "
                         f"cell")
    cfg = arch.full_config
    if n_layers is not None:
        if arch.family != "lm":
            raise ValueError(f"{arch_name}: n_layers cuts an LM's depth")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return build_trainer(arch.family, cfg, cell.meta["batch"],
                         cell.meta.get("seq", 0), accum_steps=accum_steps,
                         device=device, seed=seed)


def main(argv=None, *, mesh=None):
    """Train over ``mesh`` (default ``host_mesh()`` on ``--device``);
    returns (params, opt_state, metrics log), the parameters and moments
    ``Sharded`` leaves."""
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

    if mesh is None:
        mesh = host_mesh(device=resolve_device(args.device))
    params, step, stream = build_smoke_trainer(
        args.arch, args.batch, args.seq, args.lr, args.accum, mesh.lead,
        mesh=mesh)
    params = place_tree(params, param_shardings(get_arch(args.arch).family,
                                                mesh, params))
    opt = adamw_init(params)
    params, opt, log = run_training(
        mesh, step, params, opt, stream, n_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        param_shardings=shardings_of(params),
        opt_shardings=shardings_of(opt), log_every=args.log_every)
    print(f"[train] done: final metrics {log[-1] if log else {}}")
    return params, opt, log


if __name__ == "__main__":
    main()
