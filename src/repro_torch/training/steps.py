"""Train-step factories: the loss's gradients through autograd, optional
microbatch accumulation, then AdamW -- the PyTorch port of the JAX
package's ``training/steps.py``.

A step is a pure function of (params, opt_state, batch): the parameters
given are not written, and new trees come back.  ``loss_fn(params,
batch)`` returns ``(loss, metrics dict)``; the params it is given are
leaves that require grad, copies of the step's input.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..optim.adamw import AdamWState, adamw_update
from ..tree import tree_flatten, tree_unflatten


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


def make_train_step(loss_fn: Callable, *, lr: float = 3e-4,
                    weight_decay: float = 0.1, grad_clip: float = 1.0,
                    accum_steps: int = 1) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics dict).

    Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  With ``accum_steps > 1`` the batch's leading axis is split
    into microbatches run one after another; their gradients are summed
    in f32 and divided by ``accum_steps``, and the loss and metrics are
    their means.  The sum is added in place, and each microbatch's graph
    and gradients are freed before the next starts: beside the
    parameters and AdamW's state, a step holds one f32 gradient tree and
    one microbatch's activations and gradients."""

    def step(params, opt_state: AdamWState, batch):
        if accum_steps == 1:
            loss, metrics, grads = loss_and_grads(loss_fn, params, batch)
        else:
            acc = None
            losses, metricses = [], []
            for i in range(accum_steps):
                loss, metrics, g = loss_and_grads(
                    loss_fn, params, _micro(batch, i, accum_steps))
                if acc is None:
                    acc = [x.float() for x in g]
                else:
                    for a, x in zip(acc, g):
                        a.add_(x)
                del g
                losses.append(loss)
                metricses.append(metrics)
            grads = [a.div_(accum_steps) for a in acc]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        structure = tree_flatten(params)[1]
        new_params, new_opt = adamw_update(
            params, tree_unflatten(structure, grads), opt_state, lr=lr,
            weight_decay=weight_decay, grad_clip=grad_clip)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return step


def make_lm_train_step(cfg, **kw) -> Callable:
    from ..models.transformer import lm_loss

    def loss_fn(params, batch):
        return lm_loss(params, batch["tokens"], batch["targets"], cfg)

    return make_train_step(loss_fn, **kw)
