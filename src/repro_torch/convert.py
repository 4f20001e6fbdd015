"""Carry index state and model weights between the JAX package and the
port.

The JAX package's state is handed over as numpy arrays (``np.asarray`` of
each field), so this module needs neither package's arrays at import.  Both
directions keep every field's values and dtypes: int32 adjacency and
scalars, bool flags, f32 vectors and centroids, uint8 codes, int64
external-id tables, f32 recsys and GraphSAGE parameters, AdamW states.
LM parameters keep their values; bf16 ones (numpy has no bf16 of its
own) cross as the reference's ``ml_dtypes`` arrays one way and as exact
f32 arrays the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.config import resolve_device
from .core.graph import GraphState
from .core.lti import LTIState
from .core.pq import PQCodebook
from .models import transformer as tf
from .models.recsys import RecsysConfig, make_model
from .optim.adamw import AdamWState
from .tree import module_tree, tree_leaves, tree_map, tree_paths

GRAPH_FIELDS = ("vectors", "adjacency", "active", "deleted", "start",
                "n_total")
_DTYPES = {"vectors": np.float32, "adjacency": np.int32, "active": np.bool_,
           "deleted": np.bool_, "start": np.int32, "n_total": np.int32}


def graph_state(fields, device="cuda") -> GraphState:
    """A ``GraphState`` from an object with the six graph fields as
    attributes (e.g. the JAX ``GraphState``) or a mapping of them; each
    value is read with ``np.asarray``.  On the card unless ``device`` asks
    for the CPU."""
    device = resolve_device(device)
    get = (fields.__getitem__ if isinstance(fields, dict)
           else lambda k: getattr(fields, k))
    return GraphState(*(torch.from_numpy(np.array(
        get(k), dtype=_DTYPES[k])).to(device) for k in GRAPH_FIELDS))


def lti_state(graph, codes, centroids, device="cuda") -> LTIState:
    """An ``LTIState`` from the graph fields, the [capacity, m] uint8 codes
    and the [m, ksub, dsub] f32 codebook centroids (on the card unless
    ``device`` asks for the CPU)."""
    device = resolve_device(device)
    return LTIState(
        graph_state(graph, device),
        torch.from_numpy(np.array(codes, dtype=np.uint8)).to(device),
        PQCodebook(torch.from_numpy(np.array(
            centroids, dtype=np.float32)).to(device)))


def ext_table(ids) -> np.ndarray:
    """A slot -> external-id table as the system keeps it (host int64)."""
    return np.array(ids, dtype=np.int64)


def graph_to_numpy(state: GraphState) -> dict:
    """The port's graph fields as numpy arrays, keyed by field name."""
    return {k: getattr(state, k).cpu().numpy() for k in GRAPH_FIELDS}


def lti_to_numpy(lti: LTIState) -> dict:
    """The port's LTI as numpy arrays: the graph fields, ``codes`` and
    ``centroids`` (e.g. to compare a merged LTI with the reference's)."""
    out = graph_to_numpy(lti.graph)
    out["codes"] = lti.codes.cpu().numpy()
    out["centroids"] = lti.codebook.centroids.cpu().numpy()
    return out


def recsys_model(tree, cfg: RecsysConfig, device="cuda"):
    """The port's recsys model from the reference's parameter dict (its
    leaves read with ``np.asarray``; lists of layers keyed by position):
    each parameter takes the value and dtype of the leaf at its dotted
    name (``mlp.0.w`` is ``tree["mlp"][0]["w"]``).  On the card unless
    ``device`` asks for the CPU."""
    device = resolve_device(device)
    model = make_model(cfg)
    for name, p in model.named_parameters():
        leaf = tree
        for part in name.split("."):
            leaf = leaf[int(part)] if part.isdigit() else leaf[part]
        arr = np.asarray(leaf)
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        p.data = torch.from_numpy(np.array(arr))
    return model.to(device)


def recsys_to_numpy(model) -> dict:
    """The model's parameters as the reference's dict of numpy arrays
    (``mlp``, ``cin`` and ``blocks`` as lists), values and dtypes kept."""
    return tree_map(lambda t: t.cpu().numpy(), module_tree(model))


def _leaf_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor of a numpy leaf; a bf16 leaf (``ml_dtypes.bfloat16``,
    as ``np.asarray`` gives a JAX bf16 array) crosses by its bits."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.uint16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def lm_params(tree, cfg: tf.TransformerConfig, device="cuda") -> dict:
    """The port's LM parameters from the reference's parameter dict (its
    leaves read with ``np.asarray``; ``blocks`` a list by pattern
    position): each parameter of ``transformer.param_layout(cfg)`` takes
    the value of the leaf at its dotted name (``blocks.0.wq`` is
    ``tree["blocks"][0]["wq"]``, ``blocks.0.moe.router`` is
    ``tree["blocks"][0]["moe"]["router"]``) in the layout's dtype (the
    activation dtype for weights and biases, f32 for norms and an MoE
    router), so bf16 leaves and ``lm_to_numpy``'s exact f32 copies of
    them give the same tensors.  On the card unless ``device`` asks for
    the CPU."""
    device = resolve_device(device)
    params: dict = {}
    for name, (shape, dtype, _) in tf.param_layout(cfg).items():
        arr = np.asarray(tf.get_param(tree, name))
        if arr.shape != tuple(shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(shape)}")
        tf.set_param(params, name,
                     _leaf_tensor(arr).to(dtype).to(device))
    return params


def lm_to_numpy(params: dict) -> dict:
    """The port's LM parameters as the reference's dict of numpy arrays
    (``blocks`` a list of dicts, an MoE layer's leaves under ``moe``): f32
    leaves as f32, bf16 ones widened to f32 (exactly)."""
    out: dict = {}
    for name, t in tf.param_items(params):
        t = t.detach().cpu()
        tf.set_param(out, name, (t.float() if t.dtype == torch.bfloat16
                                 else t).numpy().copy())
    return out


def sage_params(tree, cfg, device="cuda") -> dict:
    """The port's GraphSAGE parameters from the reference's dict
    (``layers[i].{w_self, w_nbr, b}`` and ``head``; leaves read with
    ``np.asarray``), shapes checked against ``cfg``, f32.  On the card
    unless ``device`` asks for the CPU."""
    device = resolve_device(device)
    dims = [cfg.d_feat] + [cfg.d_hidden] * cfg.n_layers
    want = {"head": (cfg.d_hidden, cfg.n_classes)}
    for i in range(cfg.n_layers):
        want[f"layers.{i}.w_self"] = want[f"layers.{i}.w_nbr"] = (
            dims[i], dims[i + 1])
        want[f"layers.{i}.b"] = (dims[i + 1],)
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['layers'])} layers, cfg has "
                         f"{cfg.n_layers}")
    out = tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device), tree)
    for name, t in zip(tree_paths(out), tree_leaves(out)):
        if tuple(t.shape) != want.get(name):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{want.get(name)}")
    return out


def sage_to_numpy(params: dict) -> dict:
    """The port's GraphSAGE parameters as the reference's dict of numpy
    arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), params)


def adamw_state(state, device="cuda") -> AdamWState:
    """The port's ``AdamWState`` from one with numpy leaves (e.g. the
    reference's, each leaf read with ``np.asarray``): step int32, m and v
    f32 trees.  On the card unless ``device`` asks for the CPU."""
    device = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return AdamWState(
        torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                     device=device),
        tree_map(leaf, state.m), tree_map(leaf, state.v))


def adamw_to_numpy(state: AdamWState) -> AdamWState:
    """An ``AdamWState`` with numpy leaves (step a 0-d int32 array)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), state)
