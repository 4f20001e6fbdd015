"""Device groups, meshes and sharding rules: the PyTorch port of the JAX
package's ``distributed/sharding.py``, both of its halves.

**The ANN half.**  A 1-axis group (the ``data`` axis) is a list of
``torch.device``, one per shard; a ``[replica, data]`` grid is a list of
such lists, one per replica.  The port drives a group from ONE process
(``distributed.ctx``): each shard computes its share on its own device and
the lead device recombines them, as the reference's single program drives
its mesh under ``shard_map``.

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

**The model half.**  ``Mesh`` is a named device grid (``host_mesh`` builds
the training one, data x model).  A spec is a tuple with one entry a
dimension: ``None``, an axis name or a tuple of names, the reference's
``PartitionSpec``; ``NamedSharding`` pairs it with a mesh.  The rules
(``fsdp_rule``, ``lm_param_shardings``, ``table_sharding``,
``generic_param_shardings``, ``cache_shardings``) give the reference's spec
for every parameter, keyed on the port's dotted names (``blocks.0.wq``,
``blocks.0.moe.w_gate``, ``V``, ``layers.0.w_self``).  ``shard`` stores a
tensor as a ``Sharded`` leaf: one block per grid position, sliced along
each dimension by its axes and replicated over the axes its spec does not
name, each block on its position's device.  ``Sharded`` is a node of
``repro_torch.tree`` whose children are its blocks, so the train step's
autograd, AdamW and the tree walks see blocks as leaves;
``distributed.ctx.gathered`` puts the whole weight together where it is
used (the ZeRO-3 all-gather, whose backward hands each block its slice of
the gradient: the reduce-scatter).
"""
from __future__ import annotations

import itertools
import math
import re
from collections import OrderedDict
from typing import Any, Callable, Optional, Sequence

import numpy as np
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


# ---------------------------------------------------------------------------
# The model half: meshes, specs, the rules, sharded leaves.
# ---------------------------------------------------------------------------

class Mesh:
    """A named device grid, as ``jax.sharding.Mesh``: ``devices`` a numpy
    object array of ``torch.device`` (one entry a grid position, the same
    device may stand at several), ``axis_names`` one name an axis, and
    ``shape`` the ordered ``{axis: size}``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).flat]
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        self.devices = grid.reshape(np.shape(devices))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"Mesh: a {self.devices.ndim}-axis grid named "
                             f"{self.axis_names}")

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def lead(self) -> torch.device:
        """The device of the first grid position: where the step's scalars
        and sums live."""
        return self.devices.flat[0]

    def positions(self) -> list:
        """Every grid position (a tuple of indices), in row-major order."""
        return list(itertools.product(*(range(n)
                                        for n in self.devices.shape)))

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]})")


def host_mesh(model: int = 1, device="cuda",
              devices: Optional[Sequence] = None) -> Mesh:
    """The (data, model) training mesh, the counterpart of the reference's
    ``launch/mesh.py::make_host_mesh``: every CUDA device (or the explicit
    ``devices``, e.g. ``[cuda:0] * 4``) as ``n // model`` data rows of
    ``model`` columns.  On the CPU, ``[cpu] * model``: one data row."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        dev = torch.device(device)
        cap = census(dev)
        devs = (_devices(model, dev, None, "host_mesh") if cap is None
                else [torch.device("cuda", i) for i in range(cap)])
    if not devs or len(devs) % model:
        raise ValueError(f"host_mesh: {len(devs)} devices in rows of "
                         f"{model}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(len(devs) // model, model), ("data", "model"))


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``): what
    ``lm_param_shardings`` and its kin return a leaf, what
    ``restore_checkpoint(shardings=)`` places a leaf by."""

    def __init__(self, mesh: Mesh, spec: Sequence):
        self.mesh, self.spec = mesh, tuple(spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec})"


def batch_axes(mesh: Mesh) -> tuple:
    """The data-parallel super-axis: ('pod', 'data') when a pod axis
    exists."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axes(entry) -> tuple:
    """A spec entry's axis names: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axsize(mesh: Mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in _axes(axes))


def _entry(e):
    """A spec entry in its one spelling (``PartitionSpec``'s): a 1-tuple
    of names as the name, an empty one as None."""
    names = _axes(e)
    if not names:
        return None
    return names[0] if len(names) == 1 else names


def _fit(mesh: Mesh, dim: int, axes):
    """``axes`` if the dim is divisible by their product, else None."""
    return axes if dim % _axsize(mesh, axes) == 0 else None


def spec_for(mesh: Mesh, shape: Sequence[int], wants: Sequence) -> tuple:
    """A spec assigning ``wants[i]`` to dim i where the dim is divisible by
    its axes and no earlier dim claimed one of them; padded with None to
    the rank."""
    used: set = set()
    out = []
    for dim, want in zip(shape, wants):
        ax = _fit(mesh, dim, want)
        if ax is None:
            out.append(None)
            continue
        names = _axes(ax)
        if any(n in used for n in names):
            out.append(None)
            continue
        used.update(names)
        out.append(_entry(ax))
    out += [None] * (len(shape) - len(out))
    return tuple(out)


def _last(path: str) -> str:
    return path.rsplit(".", 1)[-1]


def fsdp_rule(mesh: Mesh, path: str, shape: Sequence[int]) -> tuple:
    """The baseline ZeRO-3 weight sharding by parameter name (dotted: the
    reference's key string's names): embedding rows over data, the head's
    vocabulary over model, norms and 1-d leaves replicated, the attention
    and FFN stacks over model on their input dim and data on a second
    one, a MoE stack's [Gn, E, D, F] over D x F (E may be tiny) and its
    router over D; the rest by ``_generic_spec``."""
    nd = len(shape)
    name = _last(path)
    if "embed" in path and nd == 2:               # [V, D]: rows over data
        return spec_for(mesh, shape, ["data", None])
    if "lm_head" in path:                         # [D, V]: V over model
        return spec_for(mesh, shape, [None, "model"])
    if nd == 1 or "ln" in path or "norm" in path or name.endswith("b"):
        return spec_for(mesh, shape, [])
    if re.search(r"w[qkv]$", name) and nd == 4:   # [Gn, D, H, dh]
        return spec_for(mesh, shape, [None, "model", None, "data"])
    if name.endswith("wo") and nd == 4:           # [Gn, H, dh, D]
        return spec_for(mesh, shape, [None, None, "data", "model"])
    if re.search(r"w_(gate|up)$", name):
        if nd == 3:                               # [Gn, D, F]
            return spec_for(mesh, shape, [None, "model", "data"])
        if nd == 4:                               # [Gn, E, D, F] (MoE)
            return spec_for(mesh, shape, [None, None, "model", "data"])
    if name.endswith("w_down"):
        if nd == 3:                               # [Gn, F, D]
            return spec_for(mesh, shape, [None, "data", "model"])
        if nd == 4:                               # [Gn, E, F, D]
            return spec_for(mesh, shape, [None, None, "data", "model"])
    if name.endswith("router"):                   # [Gn, D, E]
        return spec_for(mesh, shape, [None, "model", None])
    return _generic_spec(mesh, shape)


def _generic_spec(mesh: Mesh, shape: Sequence[int]) -> tuple:
    """The two largest dims over model and data (the first of equal dims
    first), where divisible."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    wants: list = [None] * len(shape)
    for i, ax in zip(order, ("model", "data")):
        wants[i] = ax
    return spec_for(mesh, shape, wants)


def _paths_and_leaves(tree) -> list:
    from ..tree import tree_leaves, tree_paths
    return list(zip(tree_paths(tree, is_leaf=is_sharded),
                    tree_leaves(tree, is_leaf=is_sharded)))


def _with_specs(mesh: Mesh, tree, spec_fn: Callable) -> Any:
    from ..tree import tree_flatten, tree_unflatten
    structure = tree_flatten(tree, is_leaf=is_sharded)[1]
    return tree_unflatten(structure, [
        NamedSharding(mesh, spec_fn(path, tuple(leaf.shape)))
        for path, leaf in _paths_and_leaves(tree)])


def lm_param_shardings(mesh: Mesh, params) -> Any:
    """A ``NamedSharding`` a leaf of a transformer's parameter tree (any
    leaves with a ``shape``: tensors, meta tensors), by ``fsdp_rule``."""
    return _with_specs(mesh, params,
                       lambda path, shape: fsdp_rule(mesh, path, shape))


def table_sharding(mesh: Mesh, shape: Sequence[int]) -> tuple:
    """The recsys / GNN big-table rule: rows over (data, model)
    combined."""
    return spec_for(mesh, shape, [("data", "model"), None])


def generic_param_shardings(mesh: Mesh, params, table_names=()) -> Any:
    """GNN / recsys parameters: a leaf whose dotted path holds one of
    ``table_names`` row-sharded (``table_sharding``), the rest by
    ``_generic_spec``."""
    def one(path, shape):
        if any(t in path for t in table_names):
            return table_sharding(mesh, shape)
        return _generic_spec(mesh, shape)
    return _with_specs(mesh, params, one)


def cache_shardings(mesh: Mesh, caches, batch: int) -> Any:
    """KV caches ``[Gn, B, W, KV, dh]``: B over the batch axes, W over
    model; ``pos`` replicated."""
    ba = batch_axes(mesh)

    def one(path, shape):
        if _last(path).endswith("pos"):
            return spec_for(mesh, shape, [])
        return spec_for(mesh, shape, [None, ba, "model", None, None])
    return _with_specs(mesh, caches, one)


def _slices(mesh: Mesh, spec: tuple, shape, pos: tuple) -> tuple:
    """The index of grid position ``pos``'s block of a tensor of
    ``shape``: each dim cut by its axes (the row-major index over them)."""
    coord = dict(zip(mesh.axis_names, pos))
    out = []
    for dim, entry in zip(shape, spec):
        axes = _axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        n = _axsize(mesh, axes)
        if dim % n:
            raise ValueError(f"dim {dim} over {axes} ({n} parts)")
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + coord[a]
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


class Sharded:
    """A tensor stored as blocks over a mesh: ``blocks[k]`` is grid
    position ``mesh.positions()[k]``'s block, on that position's device.
    ``shape`` is the whole tensor's, ``spec`` its spec padded to the rank.
    ``pos`` is the grid position that computes with it
    (``distributed.ctx.whole`` gathers the blocks there; None: the first
    position).  A node of ``repro_torch.tree``: its children are its
    blocks."""

    def __init__(self, mesh: Mesh, spec: Sequence, shape, blocks: list,
                 pos: Optional[tuple] = None):
        self.mesh, self.spec = mesh, tuple(spec)
        self.shape = torch.Size(shape)
        self.blocks = list(blocks)
        self.pos = pos

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.spec}, {self.dtype}, "
                f"{len(self.blocks)} blocks)")

    def with_blocks(self, blocks: list) -> "Sharded":
        return Sharded(self.mesh, self.spec, self.shape, blocks, self.pos)

    def at(self, pos: tuple) -> "Sharded":
        """The same blocks, gathered at grid position ``pos``."""
        return Sharded(self.mesh, self.spec, self.shape, self.blocks, pos)

    def block(self, pos: tuple) -> torch.Tensor:
        return self.blocks[np.ravel_multi_index(pos, self.mesh.devices.shape)]

    def _named(self) -> set:
        return {a for e in self.spec for a in _axes(e)}

    def owner(self, pos: tuple) -> bool:
        """Whether ``pos``'s block is its slice's owner: index 0 on every
        axis the spec does not name (its replicas stand elsewhere)."""
        named = self._named()
        return all(i == 0 for a, i in zip(self.mesh.axis_names, pos)
                   if a not in named)

    def slice_key(self, pos: tuple) -> tuple:
        """Which slice ``pos`` holds: its indices on the named axes."""
        named = self._named()
        return tuple(i for a, i in zip(self.mesh.axis_names, pos)
                     if a in named)

    def _entries(self, parts: list) -> list:
        """Entries of the leading axis from each block's entries
        (``parts[k]`` block k's, e.g. its ``unbind(0)``): entry i at a
        grid position is taken from the block holding i on the leading
        axis's axes, at the position's indices on the other axes (a
        replica over those axes after the cut: its gradient reaches the
        owner's block)."""
        axes = _axes(self.spec[0])
        n = _axsize(self.mesh, axes)
        size = self.shape[0] // n
        names = self.mesh.axis_names
        dims = self.mesh.devices.shape
        out = []
        for i in range(self.shape[0]):
            part, off = divmod(i, size)
            coord = dict(zip(axes, np.unravel_index(
                part, [self.mesh.shape[a] for a in axes])))
            blocks = []
            for pos in self.mesh.positions():
                src = tuple(int(coord.get(a, j)) for a, j in zip(names, pos))
                blocks.append(parts[np.ravel_multi_index(src, dims)][off])
            out.append(Sharded(self.mesh, self.spec[1:], self.shape[1:],
                               blocks, self.pos))
        return out

    def __getitem__(self, i: int) -> "Sharded":
        """Entry ``i`` of the leading axis (a stacked layer)."""
        if self.spec[0] is None:
            return Sharded(self.mesh, self.spec[1:], self.shape[1:],
                           [b[i] for b in self.blocks], self.pos)
        return self._entries(self.blocks)[i]

    def unbind(self, dim: int = 0) -> tuple:
        """Every entry of the leading axis, one ``unbind`` a block."""
        if dim != 0:
            raise ValueError("Sharded.unbind: only the leading axis")
        parts = [b.unbind(0) for b in self.blocks]
        if self.spec[0] is None:
            return tuple(Sharded(self.mesh, self.spec[1:], self.shape[1:],
                                 list(bs), self.pos) for bs in zip(*parts))
        return tuple(self._entries(parts))

    def gather(self, pos: Optional[tuple] = None, device=None
               ) -> torch.Tensor:
        """The whole tensor on ``device`` (default: ``pos``'s device) from
        the blocks ``pos`` sees: on each axis the spec names every slice,
        on the others ``pos``'s own replica.  ``torch.cat`` of the blocks
        moved with ``.to``: under autograd each block gets its slice of
        the gradient."""
        if pos is None:
            pos = self.pos if self.pos is not None else (0,) * len(
                self.mesh.axis_names)
        if device is None:
            device = self.mesh.devices[pos]
        coord = dict(zip(self.mesh.axis_names, pos))
        return self._build(0, coord, torch.device(device))

    def _build(self, k: int, coord: dict, device) -> torch.Tensor:
        if k == self.ndim:
            return self.block(tuple(coord[a] for a in self.mesh.axis_names)
                              ).to(device)
        axes = _axes(self.spec[k])
        if not axes:
            return self._build(k + 1, coord, device)
        sizes = [self.mesh.shape[a] for a in axes]
        parts = [self._build(k + 1, {**coord, **dict(zip(axes, idx))},
                             device)
                 for idx in itertools.product(*(range(n) for n in sizes))]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=k)


def is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def shard(mesh: Mesh, x: torch.Tensor, spec: Sequence = ()) -> Sharded:
    """``x`` (any device) as a ``Sharded`` leaf on ``mesh`` by ``spec``
    (padded with None to its rank): each block a copy, on its grid
    position's device."""
    spec = tuple(_entry(e) for e in spec)
    spec += (None,) * (x.dim() - len(spec))
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} for a {x.dim()}-d tensor")
    blocks = []
    for pos in mesh.positions():
        part = x[_slices(mesh, spec, x.shape, pos)]
        blocks.append(part.to(mesh.devices[pos], copy=True))
    return Sharded(mesh, spec, x.shape, blocks)


def place(x, target):
    """A leaf placed by ``target``: a ``NamedSharding`` shards it, a
    device moves it there (numpy arrays become tensors)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if isinstance(x, Sharded):
        x = x.gather(device="cpu")
    if isinstance(target, NamedSharding):
        return shard(target.mesh, x, target.spec)
    return x.to(target)


def place_tree(tree, shardings) -> Any:
    """``place`` leaf by leaf: ``shardings`` has ``tree``'s structure, a
    ``NamedSharding`` or a device at each leaf."""
    from ..tree import tree_map
    return tree_map(place, tree, shardings, is_leaf=is_sharded)


def shard_tree(mesh: Mesh, tree, spec_fn: Callable) -> Any:
    """``tree`` with every leaf sharded by ``spec_fn(path, leaf)`` (the
    leaf's dotted path): a tree of ``Sharded`` leaves."""
    from ..tree import tree_flatten, tree_unflatten
    structure = tree_flatten(tree, is_leaf=is_sharded)[1]
    return tree_unflatten(structure, [
        place(leaf, NamedSharding(mesh, spec_fn(path, leaf)))
        for path, leaf in _paths_and_leaves(tree)])


def to_full(x, device="cpu") -> torch.Tensor:
    """The counterpart of ``np.asarray(sharded)``: a ``Sharded`` leaf's
    whole value (its owner blocks) as one detached tensor on ``device``;
    a tensor is moved there."""
    if isinstance(x, Sharded):
        with torch.no_grad():
            return x.gather((0,) * len(x.mesh.axis_names), device).detach()
    return x.detach().to(device)


def shardings_of(tree) -> Any:
    """Each leaf's placement: a ``Sharded`` leaf's ``NamedSharding``, a
    tensor's device (what ``restore_checkpoint(shardings=)`` takes)."""
    from ..tree import tree_map
    return tree_map(lambda x: x.sharding if isinstance(x, Sharded)
                    else x.device, tree, is_leaf=is_sharded)


def data_positions(mesh: Mesh) -> list:
    """One grid position a data shard, in shard order: row-major over the
    batch axes, index 0 on the others (the device that computes the
    shard's rows)."""
    ba = batch_axes(mesh)
    sizes = [mesh.shape[a] for a in ba]
    out = []
    for idx in itertools.product(*(range(n) for n in sizes)):
        coord = dict(zip(ba, idx))
        out.append(tuple(coord.get(a, 0) for a in mesh.axis_names))
    return out


def place_batch(mesh: Mesh, batch: dict) -> dict:
    """A host batch placed as the reference's loop places it: each array
    of one or more axes row-sharded over the batch axes (``P(ba)``),
    other values (a per-step seed) as they are."""
    ba = batch_axes(mesh)
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1:
            t = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            out[k] = shard(mesh, t, (ba,))
        else:
            out[k] = v
    return out


def _register() -> None:
    from ..tree import register_node
    register_node(Sharded, lambda s: (s.blocks, (s.mesh, s.spec, s.shape,
                                                 s.pos)),
                  lambda aux, blocks: Sharded(aux[0], aux[1], aux[2],
                                              blocks, aux[3]))


_register()
