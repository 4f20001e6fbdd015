"""The collectives the ANN code needs, as single-process code: the PyTorch
port of the ``shard_map`` / ``psum`` / ``all_gather`` / ``axis_index``
use of ``distributed/ctx.py``.

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
non-negative value plus zeros (``x + 0.0 == x``).  The activation-sharding
half of the reference module is model scaffolding and is not ported.
"""
from __future__ import annotations

from typing import Sequence

import torch


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
