"""AdamW, hand-rolled to the JAX package's ``optim/adamw.py`` formula.

``torch.optim.AdamW`` rounds in another order (its bias correction folds
into the step size, its weight decay is applied first) and keeps its
state per parameter object; this one is a pure function of (params,
grads, state) over a tree of tensors (``repro_torch.tree``), in the
reference's order of f32 operations:

* the global norm of all gradients, in f32, clips them by one scale;
* ``c1 = 1 - b1**step`` and ``c2 = 1 - b2**step`` in f32;
* ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` on every leaf,
  biases included, cast back to the leaf's dtype.

State is ``AdamWState(step int32 [], m, v)``, m and v f32 trees shaped as
the parameters.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..tree import tree_flatten, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    leaves = tree_flatten(params)[0]
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                      tree_map(torch.zeros_like, zeros))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0):
    """Returns (new_params, new_state); the inputs are not written."""
    p_leaves, structure = tree_flatten(params)
    g_leaves = tree_flatten(grads)[0]
    m_leaves = tree_flatten(state.m)[0]
    v_leaves = tree_flatten(state.v)[0]
    gnorm = 0
    for g in g_leaves:
        gnorm = gnorm + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(gnorm)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    stepf = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=stepf.device), stepf)

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh, vh = m / c1, v / c2
        pf = p.float()
        q = pf - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * pf)
        new_p.append(q.to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    m_struct = tree_flatten(state.m)[1]
    return (tree_unflatten(structure, new_p),
            AdamWState(step, tree_unflatten(m_struct, new_m),
                       tree_unflatten(m_struct, new_v)))
