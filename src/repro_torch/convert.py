"""Carry index state between the JAX package and the port.

The JAX package's state is handed over as numpy arrays (``np.asarray`` of
each field), so this module needs neither package's arrays at import.  Both
directions keep every field's values and dtypes: int32 adjacency and
scalars, bool flags, f32 vectors and centroids, uint8 codes, int64
external-id tables.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.config import resolve_device
from .core.graph import GraphState
from .core.lti import LTIState
from .core.pq import PQCodebook

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
