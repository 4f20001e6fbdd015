"""Compressed gradient all-reduce: the PyTorch port of the JAX package's
``optim/compress.py``.

Two schemes, both honest about what would cross the links between cards:

* ``bf16_all_reduce`` -- each shard's f32 gradient cast to bf16 before the
  sum, which is taken in bf16: half the bytes of an f32 all-reduce;
* ``int8_all_gather_reduce`` -- symmetric int8 quantization with
  stochastic rounding (unbiased), the shards' 1-byte codes and one f32
  scale gathered, then decoded and summed: 4x fewer bytes a hop than f32,
  but the total grows with the shard count (use for n <= 8).

The reference runs them inside ``shard_map`` over a named axis.  The port
keeps its single-process collectives (``distributed.ctx``): each function
takes the list of the shards' gradient trees (one a data shard, in shard
order) and returns the mean tree on ``device`` (default: the first
shard's leaf's device), through ``psum`` and ``all_gather``.  The
stochastic rounding draws from an explicit ``torch.Generator`` (the
reference splits a ``jax.random`` key a leaf), one draw a shard a leaf in
leaf order; ``int8_compress_noise`` takes the noise itself.  These are
plain elementwise passes (the reference has no kernel here), and no train
step uses them by default, as none does in the reference.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..distributed.ctx import all_gather, psum
from ..tree import tree_flatten, tree_unflatten


def int8_compress_noise(g: torch.Tensor, noise: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes int8, scale f32 []) of ``g`` with the rounding noise given
    (uniform in [-0.5, 0.5), g's shape): ``round(g / scale + noise)``
    clipped to +-127, ``scale = max|g| / 127 + 1e-12``."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    x = g / scale
    q = torch.clamp(torch.round(x + noise), -127, 127).to(torch.int8)
    return q, scale


def int8_compress(g: torch.Tensor, generator: torch.Generator
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``int8_compress_noise`` with noise drawn from ``generator`` (on g's
    device): E[decompress(compress(g))] == g."""
    noise = torch.rand(g.shape, generator=generator, device=g.device,
                       dtype=torch.float32) - 0.5
    return int8_compress_noise(g, noise)


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _leaves(grads: Sequence) -> tuple[list, object]:
    flat = [tree_flatten(g) for g in grads]
    return [f[0] for f in flat], flat[0][1]


def bf16_all_reduce(grads: Sequence, device=None):
    """The mean of the shards' gradient trees, summed in bf16: each leaf
    ``(psum(bf16(g_s)).float() / n)`` cast back to the leaf's dtype."""
    per_shard, structure = _leaves(grads)
    n = len(per_shard)
    out = []
    for parts in zip(*per_shard):
        dev = parts[0].device if device is None else device
        s = psum([p.to(torch.bfloat16) for p in parts], dev)
        out.append((s.to(torch.float32) / n).to(parts[0].dtype))
    return tree_unflatten(structure, out)


def int8_all_gather_reduce(grads: Sequence, generator: torch.Generator,
                           device=None):
    """The mean of the shards' gradient trees through int8 codes: each
    shard's leaf compressed (``int8_compress``, its own draw), the codes
    and scales gathered, decoded and summed, divided by the shard count,
    cast back to the leaf's dtype.  Unbiased; each element within one
    quantization step (the largest ``max|g_s| / 127``) of the exact
    mean."""
    per_shard, structure = _leaves(grads)
    n = len(per_shard)
    out = []
    for parts in zip(*per_shard):
        dev = parts[0].device if device is None else device
        coded = [int8_compress(p.to(torch.float32), generator)
                 for p in parts]
        qs = all_gather([q for q, _ in coded], dev)          # [n, ...] int8
        ss = all_gather([s for _, s in coded], dev)          # [n]
        dec = qs.to(torch.float32) * ss.reshape(
            (-1,) + (1,) * parts[0].dim())
        out.append((dec.sum(dim=0) / n).to(parts[0].dtype))
    return tree_unflatten(structure, out)


# The reference's alias: the int8 path.
int8_all_reduce = int8_all_gather_reduce

