"""Nested containers of tensors ("trees"): the training stack's parameter
dicts, optimizer states and checkpoints.

The leaves come in the JAX package's flatten order: a dict's values by
sorted key, a list's and a tuple's in order, a NamedTuple's by field,
``None`` holding no leaf.  So the n-th leaf of a state here is the n-th
leaf of the same state in the reference, and checkpoints written by the
two packages compare one file for one file.

A class registered with ``register_node`` is a node too, its children
the leaves its flatten function gives (a sharded tensor's blocks:
``distributed.sharding.Sharded``).  Each walk takes ``is_leaf``: a node
for which it holds is kept whole as one leaf (the checkpointer saves a
sharded tensor as its full array).
"""
from __future__ import annotations

import collections
from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


# class -> (flatten(node) -> (children, aux), rebuild(aux, children))
_NODES: dict = {}


def register_node(cls, flatten: Callable, rebuild: Callable) -> None:
    """Make instances of ``cls`` nodes of every walk: ``flatten(node)``
    gives (a list of children, aux data), ``rebuild(aux, children)`` the
    node back."""
    _NODES[cls] = (flatten, rebuild)


def _flatten(node, leaves: list, is_leaf):
    if is_leaf is not None and is_leaf(node):
        leaves.append(node)
        return ("leaf",)
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys),
                tuple(_flatten(node[k], leaves, is_leaf) for k in keys))
    if _is_namedtuple(node):
        return ("namedtuple", type(node),
                tuple(_flatten(getattr(node, f), leaves, is_leaf)
                      for f in node._fields))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, len(node),
                tuple(_flatten(c, leaves, is_leaf) for c in node))
    reg = _NODES.get(type(node))
    if reg is not None:
        children, aux = reg[0](node)
        return ("node", type(node), aux,
                tuple(_flatten(c, leaves, is_leaf) for c in children))
    leaves.append(node)
    return ("leaf",)


def tree_flatten(tree, is_leaf: Callable | None = None
                 ) -> Tuple[List[Any], Any]:
    """(leaves, structure): ``tree_unflatten(structure, leaves)`` rebuilds
    the tree.  The walks are module functions, not closures: a closure
    that calls itself is a reference cycle, which would hold the leaves
    (a step's gradients, AdamW's old moments) until the cyclic garbage
    collector ran."""
    leaves: list = []
    return leaves, _flatten(tree, leaves, is_leaf)


def _build(s, it):
    kind = s[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(s[1], s[2])}
    if kind == "namedtuple":
        return s[1](*(_build(c, it) for c in s[2]))
    if kind == "node":
        return _NODES[s[1]][1](s[2], [_build(c, it) for c in s[3]])
    children = [_build(c, it) for c in s[2]]
    return children if kind == "list" else tuple(children)


def tree_unflatten(structure, leaves) -> Any:
    it = iter(leaves)
    out = _build(structure, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None
             ) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (which share its structure), leaf by leaf."""
    leaves, structure = tree_flatten(tree, is_leaf)
    others = [tree_flatten(r, is_leaf)[0] for r in rest]
    return tree_unflatten(structure,
                          [fn(*args) for args in zip(leaves, *others)])


def _paths(node, prefix: str, paths: list, is_leaf) -> None:
    if is_leaf is not None and is_leaf(node):
        paths.append(prefix)
        return
    if node is None:
        return
    if isinstance(node, dict):
        items = [(k, node[k]) for k in sorted(node)]
    elif _is_namedtuple(node):
        items = [(f, getattr(node, f)) for f in node._fields]
    elif isinstance(node, (list, tuple)):
        items = list(enumerate(node))
    elif type(node) in _NODES:
        items = list(enumerate(_NODES[type(node)][0](node)[0]))
    else:
        paths.append(prefix)
        return
    for k, v in items:
        _paths(v, f"{prefix}.{k}" if prefix else str(k), paths, is_leaf)


def tree_paths(tree, is_leaf: Callable | None = None) -> List[str]:
    """Each leaf's dotted path (``layers.0.w_self``), in leaf order (a
    registered node's children by position)."""
    paths: list = []
    _paths(tree, "", paths, is_leaf)
    return paths


def structure_to_json(structure) -> Any:
    """A structure from ``tree_flatten`` as plain JSON values (a
    NamedTuple by its class name and fields)."""
    kind = structure[0]
    if kind in ("leaf", "none"):
        return [kind]
    if kind == "node":
        raise ValueError(f"a {structure[1].__name__} node has no JSON form: "
                         "flatten it as a leaf")
    if kind == "dict":
        return ["dict", list(structure[1]),
                [structure_to_json(c) for c in structure[2]]]
    if kind == "namedtuple":
        cls = structure[1]
        return ["namedtuple", cls.__name__, list(cls._fields),
                [structure_to_json(c) for c in structure[2]]]
    return [kind, structure[1], [structure_to_json(c) for c in structure[2]]]


def structure_from_json(obj, namedtuples: dict | None = None) -> Any:
    """The inverse of ``structure_to_json``: a NamedTuple class is taken
    from ``namedtuples`` by name, or made anew with the saved fields."""
    kind = obj[0]
    if kind in ("leaf", "none"):
        return (kind,)
    if kind == "dict":
        return ("dict", tuple(obj[1]),
                tuple(structure_from_json(c, namedtuples) for c in obj[2]))
    if kind == "namedtuple":
        name, fields = obj[1], obj[2]
        cls = (namedtuples or {}).get(name) or collections.namedtuple(
            name, fields)
        return ("namedtuple", cls,
                tuple(structure_from_json(c, namedtuples) for c in obj[3]))
    return (kind, obj[1],
            tuple(structure_from_json(c, namedtuples) for c in obj[2]))


def module_tree(model) -> dict:
    """An ``nn.Module``'s parameters as a tree by their dotted names (a
    list where a name part is a position): ``mlp.0.w`` becomes
    ``tree["mlp"][0]["w"]``, the reference's parameter dict.  Detached
    copies."""
    tree: dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        node = tree
        for part, nxt in zip(parts[:-1], parts[1:]):
            key = int(part) if part.isdigit() else part
            child = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                if len(node) <= key:
                    node.append(child)
                node = node[key]
            else:
                node = node.setdefault(key, child)
        last = parts[-1]
        value = p.detach().clone()
        if isinstance(node, list):
            node.append(value)
        else:
            node[last] = value
    return tree
