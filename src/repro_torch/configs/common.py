"""Config protocol shared by every architecture module of the port: the
counterpart of the JAX package's ``configs/common.py`` for the archs
ported so far.

Each ``configs/<arch>.py`` exposes ``ARCH: ArchSpec`` with:
  * ``full_config``  -- the exact published configuration;
  * ``smoke_config`` -- a reduced same-family config for CPU smoke tests;
  * ``cells``        -- the assigned input shapes as ``Cell``s, each
    carrying ``specs()`` (``TensorSpec`` stand-ins, no allocation) and a
    step kind.

The reference's specs are ``jax.ShapeDtypeStruct``s; the port's are its
own ``TensorSpec`` records of a shape and a ``torch.dtype``.
``lm_cells`` and ``gnn_cells`` wait for their families' slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one input, without the tensor."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


S = TensorSpec


@dataclasses.dataclass(frozen=True)
class Cell:
    shape: str                 # e.g. "serve_p99"
    kind: str                  # train|serve|retrieval|ann_search|...
    specs: Callable[[], Dict[str, Any]]   # input name -> TensorSpec
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    skip: str = ""             # non-empty => documented skip


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                # lm | gnn | recsys | ann
    full_config: Any
    smoke_config: Any
    cells: Sequence[Cell]

    def cell(self, shape: str) -> Cell:
        for c in self.cells:
            if c.shape == shape:
                return c
        raise KeyError(f"{self.name}: no shape {shape}")


# ---------------------------------------------------------------------------
# Recsys cells
# ---------------------------------------------------------------------------

def recsys_cells(cfg) -> list[Cell]:
    sasrec = cfg.kind == "sasrec"

    def ids(b):
        if sasrec:
            return {"seq": S((b, cfg.seq_len), torch.int32)}
        return {"ids": S((b, cfg.n_sparse), torch.int32)}

    def train(b):
        if sasrec:
            return lambda: {
                "seq": S((b, cfg.seq_len), torch.int32),
                "pos": S((b, cfg.seq_len), torch.int32),
                "neg": S((b, cfg.seq_len), torch.int32)}
        return lambda: {**ids(b), "labels": S((b,), torch.int32)}

    def retrieval():
        d = cfg.embed_dim
        return {**ids(1),
                "item_table": S((1_048_576, d), torch.float32)}

    return [
        Cell("train_batch", "train", train(65536), {"batch": 65536}),
        Cell("serve_p99", "serve", lambda: ids(512), {"batch": 512}),
        Cell("serve_bulk", "serve", lambda: ids(262144), {"batch": 262144}),
        Cell("retrieval_cand", "retrieval", retrieval,
             {"batch": 1, "n_candidates": 1_048_576}),
    ]
