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

Sharded parameters (``distributed.sharding.Sharded``, ZeRO-3 blocks on a
mesh) get sharded moments: the optimizer state mirrors the parameters'
shardings, as the reference's does.  Every block is updated on its own
device.  The global norm counts each slice once (its owner block: the
replicas hold the same gradient, ``training.steps.reduce_replicas``): a
partial sum of squares a device, in leaf order, then the partials added
on the step counter's device in the order the devices first appear; the
clip scale and the bias corrections go back to each device.  On one
device that is the unsharded sum, term for term, so an unsharded tree
takes the same path.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..distributed.sharding import Sharded, is_sharded
from ..tree import tree_flatten, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _zeros_f32(p):
    if isinstance(p, Sharded):
        return p.with_blocks([_zeros_f32(b) for b in p.blocks])
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params) -> AdamWState:
    """Zero moments shaped (and sharded) as ``params``, step 0 on the
    device of the first leaf (a sharded tree's mesh's lead device)."""
    leaves = tree_flatten(params, is_leaf=is_sharded)[0]
    if not leaves:
        dev = torch.device("cpu")
    elif isinstance(leaves[0], Sharded):
        dev = leaves[0].mesh.lead
    else:
        dev = leaves[0].device
    m = tree_map(_zeros_f32, params, is_leaf=is_sharded)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), m,
                      tree_map(_zeros_f32, params, is_leaf=is_sharded))


def _blocks(x) -> list:
    return x.blocks if isinstance(x, Sharded) else [x]


def _owners(g) -> list:
    """The blocks of a gradient leaf the global norm counts: each slice's
    owner (all of a tensor)."""
    if not isinstance(g, Sharded):
        return [g]
    return [b for b, pos in zip(g.blocks, g.mesh.positions())
            if g.owner(pos)]


def _global_norm(g_leaves: list, lead) -> torch.Tensor:
    """The f32 global norm over the owner blocks (see the module
    docstring): a partial sum of squares a device, in leaf order, then the
    partials added on ``lead`` in the order the devices first appear."""
    partial: dict = {}
    for g in g_leaves:
        for b in _owners(g):
            partial[b.device] = (partial.get(b.device, 0)
                                 + torch.sum(torch.square(b.float())))
    gnorm = 0
    for part in partial.values():
        gnorm = gnorm + part.to(lead)
    return torch.sqrt(gnorm)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0):
    """Returns (new_params, new_state); the inputs are not written."""
    p_leaves, structure = tree_flatten(params, is_leaf=is_sharded)
    g_leaves = tree_flatten(grads, is_leaf=is_sharded)[0]
    m_leaves, m_struct = tree_flatten(state.m, is_leaf=is_sharded)
    v_leaves = tree_flatten(state.v, is_leaf=is_sharded)[0]
    gnorm = _global_norm(g_leaves, state.step.device)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    stepf = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=stepf.device), stepf)

    consts: dict = {}                     # device -> (scale, c1, c2)

    def upd(p, g, m, v):
        dev = p.device
        if dev not in consts:
            consts[dev] = tuple(x.to(dev) for x in (scale, c1, c2))
        sc, k1, k2 = consts[dev]
        g = g.float() * sc
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh, vh = m / k1, v / k2
        pf = p.float()
        q = pf - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * pf)
        return q.to(p.dtype), m, v

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        out = [upd(*x) for x in zip(_blocks(p), _blocks(g), _blocks(m),
                                    _blocks(v))]
        for acc, parts, like in ((new_p, [o[0] for o in out], p),
                                 (new_m, [o[1] for o in out], m),
                                 (new_v, [o[2] for o in out], v)):
            acc.append(like.with_blocks(parts) if isinstance(like, Sharded)
                       else parts[0])
    return (tree_unflatten(structure, new_p),
            AdamWState(step, tree_unflatten(m_struct, new_m),
                       tree_unflatten(m_struct, new_v)))
