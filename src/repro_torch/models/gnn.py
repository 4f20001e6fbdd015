"""GraphSAGE (Hamilton et al., arXiv:1706.02216): the PyTorch port of the
JAX package's ``models/gnn.py``.

Three execution regimes, matching the assigned shapes:
  * full-batch  -- one segment mean over all edges per layer
    (full_graph_sm / ogb_products), ``sage_forward_full``;
  * sampled     -- layer-wise fanout neighbour sampling from a CSR
    adjacency (minibatch_lg), ``sage_forward_sampled``;
  * batched     -- many small graphs (molecule) as one flat graph, graph
    g's nodes offset by g * n, ``sage_forward_batched``.

The segment mean ("gather rows by ``src``, sum them by ``dst``, divide by
the in-degree") is ``SegmentMean``, an ``autograd.Function`` that saves no
activation.  The reference gathers an [E, d] message buffer per layer
(24.7 GB and 31.7 GB at ogb_products' layers), and autograd through a
gather and ``torch.segment_reduce`` would keep both layers' buffers for
the backward and add a third: more than the card holds.  Instead:

* forward: the edges sorted stably by ``dst`` are walked in chunks of
  whole destination ranges, at most ``CHUNK_BYTES`` of gathered rows a
  chunk, each an ``index_select`` and a ``segment_reduce``.  Every output
  row is summed in one chunk, in edge order, with no atomics, so the card
  gives the same bits on every run;
* backward: the same walk over the transposed edge list (the dst-sorted
  edges sorted stably by ``src``) with values ``grad[dst] / deg[dst]``,
  skipped when the input needs no gradient (the first layer's features).

``SageGraph`` keeps both orders and the chunk plans of one graph, built
once.  ``segment_mean_plain`` is the unchunked form, for the tests.

The dense products run in f64 and are rounded once to f32
(``layers.matmul``), their gradients too: the card and the CPU then agree
on logits and gradients far inside ``chip_smoke.py``'s bound, where f32
sums over millions of nodes would not.

Neighbour sampling draws ``r`` in [0, 2**30) on a CPU ``torch.Generator``
and moves it to the device, so one seed samples the same neighbours on the
CPU and on the card; the reference draws from ``jax.random``, so the
parity tests hand the reference's frontiers in (``frontiers=``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import resolve_device
from .layers import matmul

# Bytes of gathered rows a segment-mean chunk holds at once (f32): 2 GiB
# is ~4.2M edges at d 128, 16 chunks a layer at ogb_products.
CHUNK_BYTES = 2 << 30


@dataclasses.dataclass(frozen=True)
class SageConfig:
    name: str
    d_feat: int
    d_hidden: int
    n_layers: int = 2
    n_classes: int = 41
    fanout: Tuple[int, ...] = (25, 10)
    aggregator: str = "mean"
    dtype: str = "float32"


def init_sage_params(cfg: SageConfig, generator: torch.Generator,
                     device="cuda") -> dict:
    """``{"layers": [{"w_self", "w_nbr", "b"}, ...], "head"}`` with the
    reference's init scales, drawn on ``generator`` (a CPU
    ``torch.Generator``: one seed gives the same weights on the CPU and
    on the card), then moved to ``device`` (the card unless the caller
    asks for the CPU).  The draws are torch's, not ``jax.random``'s: to
    hold the port against the reference, carry the reference's
    parameters across with ``convert.sage_params``."""
    device = resolve_device(device)
    dims = [cfg.d_feat] + [cfg.d_hidden] * cfg.n_layers

    def normal(*shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(device)

    layers = []
    for i in range(cfg.n_layers):
        s = dims[i] ** -0.5
        layers.append({
            "w_self": normal(dims[i], dims[i + 1], scale=s),
            "w_nbr": normal(dims[i], dims[i + 1], scale=s),
            "b": torch.zeros(dims[i + 1], device=device),
        })
    head = normal(cfg.d_hidden, cfg.n_classes, scale=cfg.d_hidden ** -0.5)
    return {"layers": layers, "head": head}


def _sage_layer(lp, h_self: torch.Tensor, h_agg: torch.Tensor):
    out = matmul(h_self, lp["w_self"]) + matmul(h_agg, lp["w_nbr"]) + lp["b"]
    out = torch.relu(out)
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out / torch.clamp(norm, min=1e-6)


# ---------------------------------------------------------------------------
# The segment mean
# ---------------------------------------------------------------------------

def _plan(offsets: np.ndarray, max_edges: int) -> list:
    """Chunks ``(n0, n1, e0, e1)`` of whole segments: nodes n0..n1-1 own
    edges e0..e1-1, at most ``max_edges`` of them unless one node owns
    more (it then is a chunk alone)."""
    n = len(offsets) - 1
    out, n0 = [], 0
    while n0 < n:
        e0 = int(offsets[n0])
        n1 = int(np.searchsorted(offsets, e0 + max_edges, side="right")) - 1
        n1 = min(max(n1, n0 + 1), n)
        out.append((n0, n1, e0, int(offsets[n1])))
        n0 = n1
    return out


class SageGraph:
    """The two edge orders of one graph of ``n_nodes`` nodes, for
    ``SegmentMean``: ``src`` sorted stably by ``dst`` with the in-degrees
    (forward), and those edges' ``dst`` sorted stably by ``src`` with the
    out-degrees (backward).  ``src``/``dst`` are any integer tensors of
    the edge list; the graph lives on their device."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n_nodes: int):
        src, dst = src.long(), dst.long()
        self.n_nodes = n_nodes
        self.device = src.device
        order = torch.sort(dst, stable=True).indices
        self.src_by_dst = src[order]
        dst_sorted = dst[order]
        del order
        back = torch.sort(self.src_by_dst, stable=True).indices
        self.dst_by_src = dst_sorted[back]
        del back, dst_sorted
        self.in_len = torch.bincount(dst, minlength=n_nodes)
        self.out_len = torch.bincount(src, minlength=n_nodes)
        self.deg = torch.clamp(self.in_len.float(), min=1.0)
        self._offsets = {
            "in": np.concatenate([[0], np.cumsum(self.in_len.cpu().numpy())]),
            "out": np.concatenate([[0],
                                   np.cumsum(self.out_len.cpu().numpy())])}
        self._plans: dict = {}

    @property
    def n_edges(self) -> int:
        return int(self.src_by_dst.shape[0])

    def plan(self, which: str, max_edges: int) -> list:
        key = (which, max_edges)
        if key not in self._plans:
            self._plans[key] = _plan(self._offsets[which], max_edges)
        return self._plans[key]


def _walk(h: torch.Tensor, idx: torch.Tensor, lengths: torch.Tensor,
          plan: list) -> torch.Tensor:
    """out[v] = sum of h[idx[e]] over the edges e of segment v, in order,
    chunk by chunk."""
    out = torch.empty((lengths.shape[0],) + tuple(h.shape[1:]),
                      dtype=h.dtype, device=h.device)
    for n0, n1, e0, e1 in plan:
        if e1 == e0:
            out[n0:n1] = 0
            continue
        rows = h.index_select(0, idx[e0:e1])
        out[n0:n1] = torch.segment_reduce(rows, "sum", lengths=lengths[n0:n1],
                                          axis=0, unsafe=True)
    return out


def _max_edges(h: torch.Tensor, max_edges: Optional[int]) -> int:
    if max_edges is not None:
        return max_edges
    row = h[0].numel() * h.element_size() if h.shape[0] else 1
    return max(1, CHUNK_BYTES // max(row, 1))


class SegmentMean(torch.autograd.Function):
    """``agg[v] = sum(h[u] for edges u -> v) / max(deg(v), 1)`` (``mean``)
    or the plain sum, over a ``SageGraph``; saves no tensor."""

    @staticmethod
    def forward(ctx, h, graph: SageGraph, mean: bool = True,
                max_edges: Optional[int] = None):
        ctx.graph, ctx.mean, ctx.max_edges = graph, mean, max_edges
        out = _walk(h, graph.src_by_dst, graph.in_len,
                    graph.plan("in", _max_edges(h, max_edges)))
        return out / graph.deg[:, None] if mean else out

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        g = ctx.graph
        if ctx.mean:
            grad = grad / g.deg[:, None]
        grad = grad.contiguous()
        gh = _walk(grad, g.dst_by_src, g.out_len,
                   g.plan("out", _max_edges(grad, ctx.max_edges)))
        return gh, None, None, None


def segment_mean(h: torch.Tensor, graph: SageGraph, mean: bool = True,
                 max_edges: Optional[int] = None) -> torch.Tensor:
    """The chunked segment mean (``SegmentMean``); ``max_edges`` overrides
    the chunk bound of ``CHUNK_BYTES``."""
    return SegmentMean.apply(h, graph, mean, max_edges)


def segment_mean_plain(h: torch.Tensor, graph: SageGraph,
                       mean: bool = True) -> torch.Tensor:
    """The unchunked form: one gather of every edge's row and one
    ``segment_reduce``, through autograd (the tests' reference)."""
    rows = h.index_select(0, graph.src_by_dst)
    out = torch.segment_reduce(rows, "sum", lengths=graph.in_len, axis=0)
    return out / graph.deg[:, None] if mean else out


# ---------------------------------------------------------------------------
# Full-batch forward
# ---------------------------------------------------------------------------

def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return lse - gold


def sage_forward_full(params, feats: torch.Tensor, graph: SageGraph,
                      cfg: SageConfig) -> torch.Tensor:
    """feats [N, F] and the graph of the (src, dst) edge list ->
    logits [N, n_classes]."""
    h = feats.float()
    for lp in params["layers"]:
        agg = segment_mean(h, graph, cfg.aggregator == "mean")
        h = _sage_layer(lp, h, agg)
    return matmul(h, params["head"])


def sage_loss_full(params, feats, graph: SageGraph, labels, mask,
                   cfg: SageConfig) -> torch.Tensor:
    """Mean cross-entropy over the nodes of ``mask``."""
    ce = _ce(sage_forward_full(params, feats, graph, cfg), labels)
    ce = torch.where(mask, ce, torch.zeros((), device=ce.device))
    return ce.sum() / torch.clamp(mask.sum(), min=1)


# ---------------------------------------------------------------------------
# Fanout neighbour sampler (CSR) + sampled forward
# ---------------------------------------------------------------------------

def sample_neighbors(generator: torch.Generator, offsets: torch.Tensor,
                     nbrs: torch.Tensor, nodes: torch.Tensor,
                     fanout: int) -> torch.Tensor:
    """Uniform with-replacement fanout sampling: offsets [N + 1], nbrs [E],
    nodes [...] -> int64 [..., fanout], ``nbrs[offsets[v] + r % deg(v)]``
    for r drawn on ``generator`` (CPU); an isolated node samples itself.
    Index arithmetic in int64."""
    nodes = nodes.long()
    start = offsets[nodes].long()
    deg = offsets[nodes + 1].long() - start
    r = torch.randint(0, 1 << 30, tuple(nodes.shape) + (fanout,),
                      generator=generator, dtype=torch.int64)
    idx = start[..., None] + r.to(nodes.device) % torch.clamp(
        deg, min=1)[..., None]
    # an isolated last node's index is E: clamped (as the reference's
    # gather clamps it), then replaced by the node itself
    picked = nbrs[torch.clamp(idx, max=max(nbrs.shape[0] - 1, 0))].long()
    return torch.where((deg > 0)[..., None], picked, nodes[..., None])


def sample_frontiers(seed: int, offsets, nbrs, seeds: torch.Tensor,
                     cfg: SageConfig) -> list:
    """[seeds, [B, f1], [B, f1, f2], ...]: each layer's draw on one CPU
    generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    frontiers = [seeds.long()]
    for l in range(cfg.n_layers):
        frontiers.append(sample_neighbors(gen, offsets, nbrs, frontiers[-1],
                                          cfg.fanout[l]))
    return frontiers


def sage_forward_sampled(params, seed, feats, offsets, nbrs, seeds,
                         cfg: SageConfig, *,
                         frontiers: Optional[Sequence] = None):
    """Layer-wise sampled forward: seeds [B] -> logits [B, n_classes].
    ``frontiers`` (``sample_frontiers``' list) replaces the draw from
    ``seed``."""
    L = cfg.n_layers
    if frontiers is None:
        frontiers = sample_frontiers(seed, offsets, nbrs, seeds, cfg)
    hs = [feats[f.to(feats.device).long()].float() for f in frontiers]
    for l in range(L - 1, -1, -1):
        lp = params["layers"][L - 1 - l]
        # aggregate frontier d+1 into frontier d for every remaining level
        hs = [_sage_layer(lp, hs[d], hs[d + 1].mean(dim=-2))
              for d in range(l + 1)]
    return matmul(hs[0], params["head"])


def sage_loss_sampled(params, seed, feats, offsets, nbrs, seeds, labels,
                      cfg: SageConfig, *,
                      frontiers: Optional[Sequence] = None):
    logits = sage_forward_sampled(params, seed, feats, offsets, nbrs, seeds,
                                  cfg, frontiers=frontiers)
    return _ce(logits, labels).mean()


# ---------------------------------------------------------------------------
# Batched small graphs (molecule shape): one flat graph
# ---------------------------------------------------------------------------

def batched_graph(src: torch.Tensor, dst: torch.Tensor,
                  edge_mask: torch.Tensor, n: int) -> SageGraph:
    """The flat graph of G padded graphs of n nodes: src/dst/edge_mask
    [G, e]; graph g's nodes become g * n .. g * n + n - 1 and a masked
    edge is dropped (in the reference it scatters to segment n, which is
    cut), so the degrees count unmasked edges only."""
    G = src.shape[0]
    off = (torch.arange(G, device=src.device) * n)[:, None]
    keep = edge_mask.bool()
    return SageGraph((src.long() + off)[keep], (dst.long() + off)[keep],
                     G * n)


def sage_forward_batched(params, feats: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, edge_mask: torch.Tensor,
                         cfg: SageConfig, *,
                         graph: Optional[SageGraph] = None):
    """feats [G, n, F], src/dst [G, e], edge_mask [G, e] -> graph logits
    [G, n_classes] (mean-pooled node embeddings -> head).  ``graph``
    (``batched_graph``'s) saves building it again."""
    G, n, F = feats.shape
    if graph is None:
        graph = batched_graph(src, dst, edge_mask, n)
    h = feats.reshape(G * n, F).float()
    for lp in params["layers"]:
        h = _sage_layer(lp, h, segment_mean(h, graph))
    return matmul(h.reshape(G, n, -1).mean(dim=1), params["head"])


def sage_loss_batched(params, feats, src, dst, edge_mask, labels,
                      cfg: SageConfig, *,
                      graph: Optional[SageGraph] = None):
    """The molecule cell's loss: mean cross-entropy over the graphs (the
    reference writes it inline in ``launch/build.py``)."""
    logits = sage_forward_batched(params, feats, src, dst, edge_mask, cfg,
                                  graph=graph)
    return _ce(logits, labels).mean()
