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
own ``TensorSpec`` records of a shape and a ``torch.dtype``, and
``cache_specs`` stands in for the reference's ``abstract_cache``.
``gnn_cells`` waits for the GraphSAGE slice.
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
# LM cells
# ---------------------------------------------------------------------------

def cache_specs(cfg, batch: int, max_len: int) -> list:
    """The specs of ``transformer.init_cache(cfg, batch, max_len)``: per
    pattern position, k and v [n_groups, batch, W, KV, dh] in the
    activation dtype and pos [W] int32 (no allocation)."""
    from ..models.transformer import cache_widths
    out = []
    for W in cache_widths(cfg, max_len):
        kv = S((cfg.n_groups, batch, W, cfg.n_kv_heads, cfg.d_head),
               cfg.act_dtype)
        out.append({"k": kv, "v": kv, "pos": S((W,), torch.int32)})
    return out


def lm_cells(cfg) -> list[Cell]:
    """The four LM shapes.  long_500k is skipped for pure full-attention
    configs (every pattern position global and no window)."""
    full_attention = all(k == "g" for k in cfg.pattern)

    def train_specs():
        return {"tokens": S((256, 4096), torch.int32),
                "targets": S((256, 4096), torch.int32)}

    def prefill_specs():
        return {"tokens": S((32, 32768), torch.int32)}

    def decode_specs(batch, seq):
        return {"caches": cache_specs(cfg, batch, seq),
                "tokens": S((batch,), torch.int32),
                "pos": S((), torch.int32)}

    return [
        Cell("train_4k", "train", train_specs,
             {"batch": 256, "seq": 4096}),
        Cell("prefill_32k", "prefill", prefill_specs,
             {"batch": 32, "seq": 32768}),
        Cell("decode_32k", "decode",
             lambda: decode_specs(128, 32768),
             {"batch": 128, "seq": 32768}),
        Cell("long_500k", "decode",
             lambda: decode_specs(1, 524288),
             {"batch": 1, "seq": 524288},
             skip=("pure full-attention arch: 500k decode needs "
                   "sub-quadratic attention (DESIGN.md §Arch-applicability)"
                   if full_attention else "")),
    ]


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
