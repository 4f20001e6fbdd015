"""Carry index state and model weights between the JAX package and the
port.

The JAX package's state is handed over as numpy arrays (``np.asarray`` of
each field), so this module needs neither package's arrays at import.  Both
directions keep every field's values and dtypes: int32 adjacency and
scalars, bool flags, f32 vectors and centroids, uint8 codes, int64
external-id tables, f32 recsys parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.config import resolve_device
from .core.graph import GraphState
from .core.lti import LTIState
from .core.pq import PQCodebook
from .models.recsys import RecsysConfig, make_model

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
    def arr(p):
        return p.detach().cpu().numpy().copy()

    if model.cfg.kind == "sasrec":
        return {"item_emb": arr(model.item_emb),
                "pos_emb": arr(model.pos_emb),
                "blocks": [{n: arr(p) for n, p in b.named_parameters()}
                           for b in model.blocks]}
    out = {"w0": arr(model.w0), "w_lin": arr(model.w_lin),
           "V": arr(model.V)}
    if model.cfg.mlp:
        out["mlp"] = [{"w": arr(lp.w), "b": arr(lp.b)} for lp in model.mlp]
    if model.cfg.cin_layers:
        out["cin"] = [arr(w) for w in model.cin]
        out["cin_head"] = arr(model.cin_head)
    return out
