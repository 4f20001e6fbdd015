"""Recsys model family: FM, DeepFM, xDeepFM (CIN), SASRec -- the PyTorch
port of the JAX package's ``models/recsys.py``, serving path (forward
values; the gradients wait for the training slice).

``RecsysModel`` holds the FM family's parameters and ``SASRec`` SASRec's,
named after the reference's parameter dict (``w0``, ``w_lin``, ``V``,
``mlp.<i>.w``/``.b``, ``cin.<i>``, ``cin_head``; ``item_emb``,
``pos_emb``, ``blocks.<i>.wq`` ... ``ln2``), so ``convert.recsys_model``
carries the reference's weights across by name.  Every function of the
reference has its counterpart here, on (model, tensors, cfg).

The paper's technique plugs in at the ``retrieval_cand`` shape: the
factorized (dot-product) part of each model scores a million candidates
through the FreshDiskANN index (or an exact batched dot as the baseline,
``retrieval_topk``).

Three departures in form, none in value:

* ``embedding_bag`` sums each bag in a fixed order (rows sorted by bag,
  then a segmented sum over the sorted rows), not with ``index_add_``,
  whose CUDA atomics add in no fixed order: the card gives the same bits
  on every run.
* ``retrieval_topk`` is one stable sort of the scores, so equal scores
  come out lowest index first, as ``jax.lax.top_k`` puts them
  (``torch.topk`` promises no order among ties on CUDA).  The reference's
  two-stage branch exists only to keep a model-sharded score matrix from
  being replicated; (score descending, index ascending) is a total
  order, so both of its branches give this one path's ids and scores.
* ``_cin_apply`` computes the CIN in row chunks of at most
  ``CIN_CHUNK_BYTES`` of outer products (``cin_chunk_rows``): at
  xDeepFM's full width a ``serve_bulk`` batch's first two layers would
  hold 15.9 and 81.8 GB at once.  Each row's result depends on that row
  alone.

The reference marks the retrieval score matrix's layout with
``distributed.ctx.shard_act`` (batch x model); the port computes on one
device, and that layout hint has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import resolve_device

# Bytes of CIN outer products [rows, d, H, m] held at once (f32): 2 GiB
# keeps a chunk's products and its matmul's operands well inside the
# card beside the model's 1.7 GB of tables, and still gives matmuls of
# ~6,900 rows x 10 positions at xDeepFM's full width.
CIN_CHUNK_BYTES = 2 << 30


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                      # fm | deepfm | xdeepfm | sasrec
    n_sparse: int = 39             # number of categorical fields
    rows_per_field: int = 100_000  # hash-bucket rows per field
    embed_dim: int = 10
    mlp: Tuple[int, ...] = ()
    cin_layers: Tuple[int, ...] = ()
    # sasrec
    n_items: int = 1_000_000
    seq_len: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    dtype: str = "float32"

    @property
    def total_rows(self) -> int:
        return self.n_sparse * self.rows_per_field


# ---------------------------------------------------------------------------
# Modules: the reference's parameter dicts as nn.Modules
# ---------------------------------------------------------------------------

def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


class _Dense(nn.Module):
    """One MLP layer: ``w`` [d_in, d_out], ``b`` [d_out]."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = _param(d_in, d_out)
        self.b = _param(d_out)


class RecsysModel(nn.Module):
    """FM / DeepFM / xDeepFM: ``w0`` [], ``w_lin`` [rows], ``V`` [rows, d],
    ``mlp`` (DeepFM, xDeepFM), ``cin`` and ``cin_head`` (xDeepFM).
    Parameters are allocated uninitialised; ``init_recsys_params`` or
    ``convert.recsys_model`` fills them."""

    def __init__(self, cfg: RecsysConfig):
        super().__init__()
        if cfg.kind == "sasrec":
            raise ValueError("RecsysModel holds the FM family; use SASRec")
        self.cfg = cfg
        rows, d = cfg.total_rows, cfg.embed_dim
        self.w0 = _param(())
        self.w_lin = _param(rows)
        self.V = _param(rows, d)
        if cfg.mlp:
            dims = [cfg.n_sparse * d] + list(cfg.mlp) + [1]
            self.mlp = nn.ModuleList(_Dense(dims[i], dims[i + 1])
                                     for i in range(len(dims) - 1))
        if cfg.cin_layers:
            hs = [cfg.n_sparse] + list(cfg.cin_layers)
            self.cin = nn.ParameterList(
                _param(hs[i + 1], hs[i], cfg.n_sparse)
                for i in range(len(cfg.cin_layers)))
            self.cin_head = _param(sum(cfg.cin_layers))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return recsys_forward(self, ids, self.cfg)


class _Block(nn.Module):
    """One SASRec block: ``wq``, ``wk``, ``wv``, ``w1``, ``w2`` [d, d] and
    the layer-norm scales ``ln1``, ``ln2`` [d]."""

    def __init__(self, d: int):
        super().__init__()
        for name in ("wq", "wk", "wv", "w1", "w2"):
            setattr(self, name, _param(d, d))
        self.ln1 = _param(d)
        self.ln2 = _param(d)


class SASRec(nn.Module):
    """SASRec: ``item_emb`` [n_items, d] (row 0 is padding), ``pos_emb``
    [seq_len, d] and ``blocks``."""

    def __init__(self, cfg: RecsysConfig):
        super().__init__()
        if cfg.kind != "sasrec":
            raise ValueError(f"SASRec holds kind 'sasrec', not {cfg.kind!r}")
        self.cfg = cfg
        d = cfg.embed_dim
        self.item_emb = _param(cfg.n_items, d)
        self.pos_emb = _param(cfg.seq_len, d)
        self.blocks = nn.ModuleList(_Block(d) for _ in range(cfg.n_blocks))

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        return sasrec_encode(self, seq, self.cfg)


def make_model(cfg: RecsysConfig) -> nn.Module:
    """The module for ``cfg.kind``, parameters uninitialised, on the CPU."""
    return SASRec(cfg) if cfg.kind == "sasrec" else RecsysModel(cfg)


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------

def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segments: torch.Tensor, n_segments: int,
                  mode: str = "sum") -> torch.Tensor:
    """Generic EmbeddingBag: ids [K], segments [K] (which bag each id
    belongs to) -> [n_segments, d].  mode: sum | mean (an empty bag gives
    zeros in both).

    Each bag is summed in a fixed order: the ids are sorted by bag
    (stably) and the sorted rows summed bag by bag with
    ``torch.segment_reduce`` -- the same bits on every run, on the card
    too, in memory of the ids' rows, whatever the longest bag."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', not {mode!r}")
    dev = table.device
    seg = segments.to(dev, torch.int64)
    order = torch.sort(seg, stable=True).indices
    cnt = torch.bincount(seg, minlength=n_segments)[:n_segments]
    rows = table[ids.to(dev, torch.int64)[order]]
    out = torch.segment_reduce(rows, "sum", lengths=cnt, axis=0)
    if mode == "mean":
        out = out / torch.clamp(cnt.to(out.dtype), min=1.0)[:, None]
    return out


def field_lookup(table: torch.Tensor, ids: torch.Tensor,
                 cfg: RecsysConfig) -> torch.Tensor:
    """One-id-per-field lookup: ids [B, n_sparse] (already offset per field)
    -> [B, n_sparse, d].  The common Criteo-style fast path."""
    return F.embedding(ids.long(), table)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_recsys_params(gen: torch.Generator, cfg: RecsysConfig,
                       device="cuda") -> nn.Module:
    """A model of ``cfg`` with the reference's init scales, drawn on
    ``gen`` (a CPU ``torch.Generator``: one seed gives the same weights
    on the CPU and on the card), then moved to ``device`` (the card
    unless the caller asks for the CPU).  The draws are torch's, not
    ``jax.random``'s: to hold the port against the reference, carry the
    reference's parameters across with ``convert.recsys_model``."""
    device = resolve_device(device)
    model = make_model(cfg)

    def normal(p, scale):
        p.normal_(generator=gen).mul_(scale)

    with torch.no_grad():
        if cfg.kind == "sasrec":
            d = cfg.embed_dim
            normal(model.item_emb, 0.01)
            normal(model.pos_emb, 0.01)
            for bp in model.blocks:
                for name in ("wq", "wk", "wv", "w1", "w2"):
                    normal(getattr(bp, name), d ** -0.5)
                bp.ln1.zero_()
                bp.ln2.zero_()
        else:
            model.w0.zero_()
            normal(model.w_lin, 0.01)
            normal(model.V, 0.01)
            for lp in getattr(model, "mlp", ()):
                normal(lp.w, lp.w.shape[0] ** -0.5)
                lp.b.zero_()
            for w in getattr(model, "cin", ()):
                normal(w, (w.shape[1] * cfg.n_sparse) ** -0.5)
            if cfg.cin_layers:
                normal(model.cin_head, 0.01)
    return model.to(device)


# ---------------------------------------------------------------------------
# FM family forwards
# ---------------------------------------------------------------------------

def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """O(n*k) sum-square trick: 0.5 * sum_k((Σ_i v_ik)^2 - Σ_i v_ik^2)."""
    s = emb.sum(-2)
    sq = (emb * emb).sum(-2)
    return 0.5 * (s * s - sq).sum(-1)


def _mlp_apply(mlp, x: torch.Tensor) -> torch.Tensor:
    for i, lp in enumerate(mlp):
        x = x @ lp.w + lp.b
        if i < len(mlp) - 1:
            x = torch.relu(x)
    return x[..., 0]


def cin_chunk_rows(cin, emb_shape) -> int:
    """Rows of a CIN chunk: as many as keep one layer's outer products
    [rows, d, H, m] within ``CIN_CHUNK_BYTES``."""
    _, m, d = emb_shape
    h_max = max(int(w.shape[1]) for w in cin)
    return max(1, CIN_CHUNK_BYTES // (4 * d * h_max * m))


def _cin_rows(cin, cin_head, x0: torch.Tensor) -> torch.Tensor:
    """The CIN on one chunk of rows, x0 [b, m, d] -> [b].  Layer k's
    ``z[b, h, m, d] = xk[b, h, d] * x0[b, m, d]`` is formed as [b, d, h, m]
    and contracted with ``w`` [H_k, h, m] in one matmul over (h, m)."""
    b, m, d = x0.shape
    x0t = x0.transpose(1, 2)                       # [b, d, m]
    xk_t = x0t                                     # [b, d, H_{k-1}]
    pooled = []
    for w in cin:                                  # w: [H_k, H_{k-1}, m]
        h = xk_t.shape[-1]
        z = xk_t[:, :, :, None] * x0t[:, :, None, :]   # [b, d, h, m]
        xk_t = (z.reshape(b * d, h * m) @ w.reshape(w.shape[0], h * m).T
                ).reshape(b, d, w.shape[0])
        pooled.append(xk_t.sum(1))                 # [b, H_k]
    return torch.cat(pooled, -1) @ cin_head


def _cin_apply(cin, cin_head, emb: torch.Tensor) -> torch.Tensor:
    """Compressed Interaction Network (xDeepFM §3): x0 [B, m, d] -> [B],
    in row chunks of ``cin_chunk_rows``."""
    rows = cin_chunk_rows(cin, emb.shape)
    return torch.cat([_cin_rows(cin, cin_head, emb[lo:lo + rows])
                      for lo in range(0, emb.shape[0], rows)])


def recsys_forward(model: RecsysModel, ids: torch.Tensor,
                   cfg: RecsysConfig) -> torch.Tensor:
    """ids int32 [B, n_sparse] (pre-offset per field) -> logits [B]."""
    emb = field_lookup(model.V, ids, cfg)                 # [B, m, d]
    lin = model.w_lin[ids.long()].sum(-1)                 # [B]
    out = model.w0 + lin
    if cfg.kind in ("fm", "deepfm"):
        out = out + fm_interaction(emb)
    if cfg.kind in ("deepfm", "xdeepfm") and cfg.mlp:
        out = out + _mlp_apply(model.mlp, emb.reshape(emb.shape[0], -1))
    if cfg.kind == "xdeepfm" and cfg.cin_layers:
        out = out + _cin_apply(model.cin, model.cin_head, emb)
    return out


def recsys_loss(model: RecsysModel, ids: torch.Tensor, labels: torch.Tensor,
                cfg: RecsysConfig) -> torch.Tensor:
    logits = recsys_forward(model, ids, cfg)
    return torch.mean(F.softplus(logits) - labels.to(torch.float32) * logits)


# ---------------------------------------------------------------------------
# SASRec
# ---------------------------------------------------------------------------

def sasrec_encode(model: SASRec, seq: torch.Tensor,
                  cfg: RecsysConfig) -> torch.Tensor:
    """seq int32 [B, S] (0 = padding) -> hidden [B, S, d].  Masked scores
    are -1e30, not -inf: a padded query row, all of whose keys are masked,
    softmaxes to uniform (and is zeroed after the block) instead of
    NaN."""
    B, S = seq.shape
    d = cfg.embed_dim
    seq = seq.long()
    h = F.embedding(seq, model.item_emb) * (d ** 0.5)
    h = h + model.pos_emb[None, :S]
    pad = (seq == 0)[..., None]
    h = h.masked_fill(pad, 0.0)
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=seq.device))
    keep = causal[None] & ~pad.transpose(1, 2)             # [B, S, S]
    for bp in model.blocks:
        hn = _layer_norm(h, bp.ln1)
        q, k, v = hn @ bp.wq, hn @ bp.wk, hn @ bp.wv
        s = (q @ k.transpose(1, 2)) / (d ** 0.5)
        s = s.masked_fill(~keep, -1e30)
        h = h + torch.softmax(s, -1) @ v
        hn = _layer_norm(h, bp.ln2)
        h = h + torch.relu(hn @ bp.w1) @ bp.w2
        h = h.masked_fill(pad, 0.0)
    return h


def _layer_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * (1.0 + scale)


def sasrec_loss(model: SASRec, seq: torch.Tensor, pos_items: torch.Tensor,
                neg_items: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """BPR-style loss with sampled negatives (SASRec §3.5).
    seq [B, S]; pos/neg [B, S] targets per position."""
    h = sasrec_encode(model, seq, cfg)
    pe = F.embedding(pos_items.long(), model.item_emb)
    ne = F.embedding(neg_items.long(), model.item_emb)
    ps = (h * pe).sum(-1)
    ns = (h * ne).sum(-1)
    mask = (pos_items != 0).to(torch.float32)
    loss = F.softplus(-(ps - ns)) * mask
    return loss.sum() / torch.clamp(mask.sum(), min=1.0)


def sasrec_user_embedding(model: SASRec, seq: torch.Tensor,
                          cfg: RecsysConfig) -> torch.Tensor:
    """Final-position hidden state -- the retrieval query vector."""
    return sasrec_encode(model, seq, cfg)[:, -1]


# ---------------------------------------------------------------------------
# Retrieval scoring (the paper-technique integration point)
# ---------------------------------------------------------------------------

def retrieval_scores(query_vecs: torch.Tensor,
                     item_table: torch.Tensor) -> torch.Tensor:
    """Exact candidate scoring: [B, d] x [C, d] -> [B, C] inner products.
    The ANN path replaces this with a FreshDiskANN search over
    ``item_table``; this is the brute-force baseline."""
    return query_vecs @ item_table.T


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal
    values lowest index first (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def retrieval_topk(query_vecs: torch.Tensor, item_table: torch.Tensor,
                   k: int):
    """The k best-scoring candidates of each query, equal scores lowest
    index first: the reference's ids and scores in either of its
    branches.  Returns (scores [B, k], ids [B, k] int64)."""
    return _top_k(retrieval_scores(query_vecs, item_table), k)
