"""The collectives, as single-process code, and the activation-sharding
context: the PyTorch port of the JAX package's ``distributed/ctx.py``.

The reference runs one program over a mesh under ``shard_map``: every
shard executes the same function on its block, ``axis_index`` names the
shard and a collective recombines the shards' values.  The port keeps
that one-process shape: the caller loops over a device group
(``distributed.sharding``), shard s computes its contribution on its own
device (its loop index stands for ``axis_index``), and the functions below
recombine the contributions on the lead device.  It does not use
``torch.distributed`` with a process per shard: ``FreshDiskANN`` is one
object whose LTI lane the whole group serves.

Sums are exact where the reference's are: integer contributions add
exactly, and the owner-computes float contributions are one finite
non-negative value plus zeros (``x + 0.0 == x``).

**The activation-sharding context.**  Model code is mesh-agnostic: the
train step runs under ``activation_sharding(mesh)``, and the models call

* ``shard_act(x, 'batch', 'model', None, ...)`` where the reference
  constrains an activation's layout.  It computes the reference's spec
  (the same tag expansion, divisibility and used-axis rules) and passes x
  through ``_constrain(x, spec)``, which returns x as it is: the
  reference's constraint changes no value either, and the port computes a
  data shard's rows on one device of its row.  The spec is the hint a
  multi-process port would act on; tests read it by patching
  ``_constrain``.
* ``gathered(w)`` where the reference gathers a ZeRO-3 weight before use:
  a ``Sharded`` leaf becomes its whole value on the device that computes
  (``torch.cat`` of its blocks moved with ``.to``, so autograd hands each
  block its slice of the gradient: the reduce-scatter), then the fully
  replicated spec passes through ``_constrain``.
* ``whole(w)`` where the reference reads a parameter with no hint (a norm,
  a bias, the embedding table, the head): the same gather, no spec.

Outside a context, or given a plain tensor, ``shard_act`` and ``gathered``
are identities in value (a ``Sharded`` leaf is still gathered: a sharded
array is usable anywhere in the reference too).  Which device computes is
a property of the leaf (``Sharded.pos``, set by the step a data shard),
not of the context: a checkpointed layer's recompute runs in autograd's
own thread, where the context is not set, and must gather the same
blocks.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch

from .sharding import Mesh, Sharded, _axsize


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of the shards' contributions, on ``device``, added in shard
    order."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def all_gather(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards' values stacked on a new leading shard axis, on
    ``device``: [n_shards, ...]."""
    return torch.stack([p.to(device) for p in parts])


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh: Optional[Mesh]):
    """Within the block, ``shard_act`` and ``gathered`` emit their specs
    against ``mesh``."""
    token = _CTX.set(mesh)
    try:
        yield
    finally:
        _CTX.reset(token)


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``activation_sharding`` block, or None."""
    return _CTX.get()


def _expand(tag, ba):
    """'batch' -> the (pod, data) super-axis; tuples may mix tags."""
    if tag is None:
        return None
    if tag == "batch":
        return ba
    if isinstance(tag, str):
        return (tag,)
    out: tuple = ()
    for t in tag:
        e = _expand(t, ba)
        if e:
            out += e
    return out


def _constrain(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The layout hint: returns ``x`` unchanged (see the module
    docstring)."""
    return x


def shard_act(x: torch.Tensor, *dims) -> torch.Tensor:
    """Hint that dim i of ``x`` follows dims[i]: 'batch' (the ('pod',
    'data') super-axis), a mesh axis name, a tuple of tags, or None.  A
    tag is dropped for a dim whose size its axes do not divide or whose
    axis an earlier dim took, so the same model code is legal for every
    architecture, shape and mesh."""
    mesh = _CTX.get()
    if mesh is None:
        return x
    ba = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    spec = []
    used: set = set()
    for tag, size in zip(dims, x.shape):
        names = _expand(tag, ba)
        if not names:
            spec.append(None)
            continue
        names = tuple(n for n in names if n in mesh.axis_names)
        if (not names or any(n in used for n in names)
                or size % _axsize(mesh, names) != 0):
            spec.append(None)
            continue
        used.update(names)
        spec.append(names if len(names) > 1 else names[0])
    spec += [None] * (x.dim() - len(spec))
    return _constrain(x, tuple(spec))


def whole(w):
    """A ``Sharded`` leaf's whole value on the device of the grid position
    that computes with it (``Sharded.gather``, differentiable in the
    blocks); a tensor as it is."""
    return w.gather() if isinstance(w, Sharded) else w


def gathered(w):
    """ZeRO-3 weight gather: ``whole(w)``, hinted fully replicated inside
    a context."""
    w = whole(w)
    if _CTX.get() is None:
        return w
    return _constrain(w, (None,) * w.dim())
