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
``cache_specs`` stands in for the reference's ``abstract_cache``.  The
sampled GNN cell's ``jax.random`` key (uint32 [2]) is a per-step ``seed``
(int64 []) in the port, the seed of its CPU sampling generator.
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
# GNN cells (graphsage)
# ---------------------------------------------------------------------------

def gnn_cells(cfg) -> list[Cell]:
    def full(n, e, f):
        return lambda: {
            "feats": S((n, f), torch.float32),
            "src": S((e,), torch.int32), "dst": S((e,), torch.int32),
            "labels": S((n,), torch.int32), "mask": S((n,), torch.bool),
        }

    def sampled(n, e, b):
        return lambda: {
            "feats": S((n, 602), torch.float32),
            "offsets": S((n + 1,), torch.int32),
            "nbrs": S((e,), torch.int32),
            "seeds": S((b,), torch.int32),
            "labels": S((b,), torch.int32),
            "seed": S((), torch.int64),
        }

    def molecule(g, n, e, f):
        return lambda: {
            "feats": S((g, n, f), torch.float32),
            "src": S((g, e), torch.int32), "dst": S((g, e), torch.int32),
            "edge_mask": S((g, e), torch.bool),
            "labels": S((g,), torch.int32),
        }

    return [
        Cell("full_graph_sm", "train_full", full(2708, 10556, 1433),
             {"d_feat": 1433, "n_classes": 7}),
        Cell("minibatch_lg", "train_sampled",
             sampled(232965, 114615892, 1024),
             {"d_feat": 602, "n_classes": 41, "fanout": (15, 10)}),
        Cell("ogb_products", "train_full", full(2449029, 61859140, 100),
             {"d_feat": 100, "n_classes": 47}),
        Cell("molecule", "train_batched", molecule(128, 30, 64, 32),
             {"d_feat": 32, "n_classes": 2}),
    ]


def gnn_cell_config(cfg, cell: Cell):
    """``cfg`` specialised to ``cell`` as the reference's launch layer does
    (``launch/build.py``): its ``d_feat``, ``n_classes`` and, where the
    cell names one, ``fanout``."""
    meta = cell.meta
    return dataclasses.replace(
        cfg, d_feat=meta["d_feat"], n_classes=meta["n_classes"],
        fanout=tuple(meta.get("fanout", cfg.fanout)))


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
