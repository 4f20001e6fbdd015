"""Device groups and the row-sharded LTI lane's layout: the PyTorch port of
the ANN half of ``distributed/sharding.py``.

A JAX mesh becomes an explicit device list.  A 1-axis group (the ``data``
axis) is a list of ``torch.device``, one per shard; a ``[replica, data]``
grid is a list of such lists, one per replica.  The port drives a group
from ONE process (``distributed.ctx``): each shard computes its share on
its own device and the lead device recombines them, as the reference's
single program drives its mesh under ``shard_map``.

* On CUDA a group of n shards is ``cuda:0 ... cuda:n-1``, and asking for
  more than ``torch.cuda.device_count()`` raises, as the reference raises
  past ``len(jax.devices())`` (the system and ``ReplicaSet`` cap first).
* On the CPU every shard is the host: a CPU group of n shards is
  ``[cpu] * n``, and the census does not cap it.  This is the one
  deliberate difference from the reference, whose CPU meshes are JAX's
  fake host devices (``--xla_force_host_platform_device_count``), which
  have no torch counterpart; every shard of a CPU group still computes its
  own owner share, so the sharded code runs whole.
* Every function also takes an explicit ``devices=`` list, e.g. four
  shards on one card (``[cuda:0] * 4``).

The model-parallel rules of the reference module (``fsdp_rule``,
``lm_param_shardings``, ...) belong to its model scaffolding and are not
ported with the ANN half.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.graph import GraphState

ROWS = "rows"              # split into n contiguous row blocks
REPLICATED = "replicated"  # a copy on every shard


def census(device="cuda") -> Optional[int]:
    """The number of devices a group of ``device``'s type may span: the
    CUDA device count, or None (no cap) for the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"unsupported device type {dev.type}")
    return torch.cuda.device_count()


def _devices(n: int, device, devices: Optional[Sequence], what: str
             ) -> list[torch.device]:
    if n < 1:
        raise ValueError(f"{what}: {n} devices requested")
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if n > len(devs):
            raise ValueError(f"{what}: {n} devices requested but the "
                             f"explicit list holds {len(devs)}")
        return devs[:n]
    dev = torch.device(device)
    cap = census(dev)
    if cap is None:
        return [dev] * n
    if n > cap:
        raise ValueError(f"{what}: {n} devices requested but only {cap} "
                         f"present")
    return [torch.device("cuda", i) for i in range(n)]


def data_mesh(n_shards: int, device="cuda",
              devices: Optional[Sequence] = None) -> list[torch.device]:
    """A 1-axis group of ``n_shards`` devices: the first ``n_shards`` of
    ``devices`` when given, else ``cuda:0 ...`` (or the host n times for
    ``device="cpu"``)."""
    return _devices(n_shards, device, devices, "data_mesh")


def replica_mesh(n_replicas: int, n_shards: int = 1, device="cuda",
                 devices: Optional[Sequence] = None
                 ) -> list[list[torch.device]]:
    """The ``[n_replicas, n_shards]`` serving grid: rows are data-parallel
    replicas (each serves whole queries against a full copy of the index),
    columns the within-replica LTI row shards, filled row-major from the
    first ``n_replicas * n_shards`` devices."""
    flat = _devices(n_replicas * n_shards, device, devices, "replica_mesh")
    return [flat[r * n_shards:(r + 1) * n_shards]
            for r in range(n_replicas)]


def replica_groups(mesh: Sequence[Sequence]) -> list[list[torch.device]]:
    """The per-replica 1-axis groups of a replica grid: its rows, which is
    what ``serving.steps.make_sharded_unified_step`` takes."""
    return [list(row) for row in mesh]


def lti_lane_specs():
    """(GraphState of specs, codes spec) for the row-sharded LTI lane: the
    per-point arrays split into row blocks, the entry point and the
    allocation watermark replicated."""
    graph = GraphState(vectors=ROWS, adjacency=ROWS, active=ROWS,
                       deleted=ROWS, start=REPLICATED, n_total=REPLICATED)
    return graph, ROWS


def _place(x: torch.Tensor, spec: str, devices: list, s: int):
    if spec == REPLICATED:
        return x.to(devices[s])
    n_local = x.shape[0] // len(devices)
    return x[s * n_local:(s + 1) * n_local].to(devices[s])


def place_lti_lane(devices: Sequence, graph: GraphState,
                   codes: torch.Tensor
                   ) -> tuple[list[GraphState], list[torch.Tensor]]:
    """Split an LTI graph and its PQ codes over ``devices``: shard s gets
    slots ``[s*cap/n, (s+1)*cap/n)`` of every per-point array on
    ``devices[s]`` (a view when it already lies there) and its own copy of
    the replicated scalars.  The capacity must be a multiple of the group
    size (``graph.shard_lti`` pads it)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if graph.capacity % n or codes.shape[0] != graph.capacity:
        raise ValueError(f"place_lti_lane: capacity {graph.capacity} and "
                         f"{codes.shape[0]} code rows over {n} shards")
    gspecs, cspec = lti_lane_specs()
    graphs = [GraphState(*(_place(x, sp, devices, s)
                           for x, sp in zip(graph, gspecs)))
              for s in range(n)]
    return graphs, [_place(codes, cspec, devices, s) for s in range(n)]
