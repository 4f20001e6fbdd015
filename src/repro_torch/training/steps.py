"""Train-step factories: the loss's gradients through autograd, optional
microbatch accumulation, then AdamW -- the PyTorch port of the JAX
package's ``training/steps.py``.

A step is a pure function of (params, opt_state, batch): the parameters
given are not written, and new trees come back.  ``loss_fn(params,
batch)`` returns ``(loss, metrics dict)``; the params it is given are
leaves that require grad, copies of the step's input.

Given a ``mesh`` (``distributed.sharding.Mesh``), the step is the
reference's jitted step over that mesh, data parallel: the batch's
leading axis is split over the batch axes (blocks of ``P(ba)``, as the
reference's loop places them; a batch already placed by
``sharding.place_batch`` is read block by block), each data shard runs
its microbatches on its device under ``activation_sharding(mesh)``
against the parameters' ZeRO-3 blocks, the shards' block gradients are
summed in shard order and divided by the number of microbatches, the
replicas of each block summed so every copy gets the same gradient, and
AdamW updates each block on its own device.  The result is the
reference's function: the mean loss over the whole batch, clipped at the
global norm.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..distributed.ctx import activation_sharding
from ..distributed.sharding import Sharded, data_positions, is_sharded
from ..optim.adamw import AdamWState, adamw_update
from ..tree import tree_flatten, tree_map, tree_unflatten


def loss_and_grads(loss_fn: Callable, params, batch):
    """(loss, metrics, gradient leaves in the params' leaf order) of
    ``loss_fn(params, batch)``, all detached; a leaf the loss does not
    reach gets a zero gradient."""
    leaves, structure = tree_flatten(params)
    live = [p.detach().requires_grad_(p.is_floating_point())
            for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(structure, live), batch)
        want = [p for p in live if p.requires_grad]
        got = iter(torch.autograd.grad(loss, want, allow_unused=True))
    grads = []
    for p in live:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _micro(batch: dict, i: int, n: int) -> dict:
    """Microbatch ``i`` of ``n``: each array of one or more axes split on
    its leading axis; scalars and other values (a per-step seed, a graph)
    go to every microbatch whole."""
    out = {}
    for k, x in batch.items():
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1:
            b = x.shape[0] // n
            out[k] = x[i * b:(i + 1) * b]
        else:
            out[k] = x
    return out


def _accumulate(loss_fn: Callable, params, batch, n: int, losses,
                metricses):
    """``n`` microbatches of ``batch`` one after another: their gradients'
    sum, f32, added in place, each microbatch's graph and gradients freed
    before the next."""
    acc = None
    for i in range(n):
        loss, metrics, g = loss_and_grads(
            loss_fn, params, batch if n == 1 else _micro(batch, i, n))
        if acc is None:
            acc = [x.float() for x in g]
        else:
            for a, x in zip(acc, g):
                a.add_(x)
        del g
        losses.append(loss)
        metricses.append(metrics)
    return acc


def mean_metrics(losses: list, metricses: list, device) -> tuple:
    """The microbatches' mean loss and metrics, on ``device``."""
    def mean(xs):
        return torch.stack([x.to(device) for x in xs]).mean()
    return mean(losses), {k: mean([m[k] for m in metricses])
                          for k in metricses[0]}


def train_grads(loss_fn: Callable, *, accum_steps: int = 1,
                mesh=None) -> Callable:
    """grads_fn(params, batch) -> (loss, metrics, gradient tree): the
    first half of ``make_train_step``'s step (the mean gradient AdamW
    takes, f32 where microbatches or shards were summed)."""
    if mesh is not None:
        return _mesh_grads(loss_fn, accum_steps, mesh)

    def grads_fn(params, batch):
        structure = tree_flatten(params)[1]
        if accum_steps == 1:
            loss, metrics, grads = loss_and_grads(loss_fn, params, batch)
        else:
            losses, metricses = [], []
            acc = _accumulate(loss_fn, params, batch, accum_steps, losses,
                              metricses)
            grads = [a.div_(accum_steps) for a in acc]
            loss, metrics = mean_metrics(losses, metricses,
                                         losses[0].device)
        return loss, metrics, tree_unflatten(structure, grads)
    return grads_fn


def shard_part(batch: dict, s: int, n: int, pos: tuple, device) -> dict:
    """Data shard ``s`` of ``n`` of a batch, on ``device``: a placed leaf's
    block at grid position ``pos``, an array's ``s``-th run of rows (its
    leading axis split in n), other values whole."""
    out = {}
    for k, x in batch.items():
        if isinstance(x, Sharded):
            out[k] = x.block(pos).to(device)
        elif isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1:
            x = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
            b = x.shape[0] // n
            out[k] = x[s * b:(s + 1) * b].to(device)
        else:
            out[k] = x
    return out


def shard_microbatches(mesh, accum_steps: int) -> int:
    """Microbatches a data shard runs: ``accum_steps`` counts the whole
    batch's, as the unsharded step's, split over the data shards (at
    least one a shard)."""
    n = len(data_positions(mesh))
    if accum_steps > 1 and accum_steps % n:
        raise ValueError(f"accum_steps {accum_steps} over {n} data shards")
    return max(1, accum_steps // n)


def shard_contributions(loss_fn: Callable, params, batch, mesh,
                        accum_steps: int, losses: list, metricses: list):
    """Yields each data shard's summed f32 block gradients over its
    ``shard_microbatches`` microbatches (a list in the parameters' leaf
    order), in shard order; the microbatches' losses and metrics are
    appended to ``losses`` and ``metricses``."""
    positions = data_positions(mesh)
    per = shard_microbatches(mesh, accum_steps)
    for s, pos in enumerate(positions):
        part = shard_part(batch, s, len(positions), pos, mesh.devices[pos])
        here = tree_map(lambda x: x.at(pos) if isinstance(x, Sharded)
                        else x, params, is_leaf=is_sharded)
        with activation_sharding(mesh):
            acc = _accumulate(loss_fn, here, part, per, losses, metricses)
        del part, here
        yield acc


def reduce_replicas(grads) -> object:
    """Each ``Sharded`` gradient's replicas summed (row-major order, on
    the first replica's device) and the sum given to every copy, so that
    no two copies of a block drift apart."""
    def one(g):
        if not isinstance(g, Sharded):
            return g
        groups: dict = {}
        for k, pos in enumerate(g.mesh.positions()):
            groups.setdefault(g.slice_key(pos), []).append(k)
        blocks = list(g.blocks)
        for ks in groups.values():
            total = blocks[ks[0]]
            for k in ks[1:]:
                total = total + blocks[k].to(total.device)
            for k in ks:
                blocks[k] = total.to(blocks[k].device)
        return g.with_blocks(blocks)
    return tree_map(one, grads, is_leaf=is_sharded)


def combine_contributions(parts, params, mesh, accum_steps: int):
    """The mean gradient tree of the shards' summed gradients (an
    iterable, in shard order): added in shard order, divided by the
    microbatch count, replicas reduced (``reduce_replicas``)."""
    total = None
    for acc in parts:
        if total is None:
            total = acc
        else:
            for a, x in zip(total, acc):
                a.add_(x.to(a.device))
        del acc
    n = shard_microbatches(mesh, accum_steps) * len(data_positions(mesh))
    grads = [a.div_(n) for a in total]
    return reduce_replicas(tree_unflatten(tree_flatten(params)[1], grads))


def _mesh_grads(loss_fn: Callable, accum_steps: int, mesh) -> Callable:
    def grads_fn(params, batch):
        losses, metricses = [], []
        grads = combine_contributions(
            shard_contributions(loss_fn, params, batch, mesh, accum_steps,
                                losses, metricses), params, mesh,
            accum_steps)
        loss, metrics = mean_metrics(losses, metricses, mesh.lead)
        return loss, metrics, grads
    return grads_fn


def make_train_step(loss_fn: Callable, *, lr: float = 3e-4,
                    weight_decay: float = 0.1, grad_clip: float = 1.0,
                    accum_steps: int = 1, mesh=None) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics dict).

    Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  With ``accum_steps > 1`` the batch's leading axis is split
    into microbatches run one after another; their gradients are summed
    in f32 and divided by ``accum_steps``, and the loss and metrics are
    their means.  The sum is added in place, and each microbatch's graph
    and gradients are freed before the next starts: beside the
    parameters and AdamW's state, a step holds one f32 gradient tree and
    one microbatch's activations and gradients.  With a ``mesh`` the step
    is data parallel over its batch axes (see the module docstring; a
    data shard holds one more f32 gradient tree while it runs)."""
    grads_fn = train_grads(loss_fn, accum_steps=accum_steps, mesh=mesh)

    def step(params, opt_state: AdamWState, batch):
        loss, metrics, grads = grads_fn(params, batch)
        new_params, new_opt = adamw_update(
            params, grads, opt_state, lr=lr, weight_decay=weight_decay,
            grad_clip=grad_clip)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return step


def make_lm_train_step(cfg, **kw) -> Callable:
    from ..models.transformer import lm_loss

    def loss_fn(params, batch):
        return lm_loss(params, batch["tokens"], batch["targets"], cfg)

    return make_train_step(loss_fn, **kw)
