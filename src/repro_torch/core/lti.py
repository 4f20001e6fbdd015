"""The Long-Term Index (LTI) -- the storage-resident tier (paper §5.1),
PyTorch port of ``core/lti.py``.

An LTI is a FreshVamana graph navigated with PQ codes (ADC) and reranked
with exact distances over its full-precision vectors, as in DiskANN.  In
the system it rides as the PQ lane of ``index.unified_search``;
``search_lti`` is the standalone engine of the same lane.  All of it --
vectors, adjacency and codes -- lives in device memory; with
``SystemConfig.storage_dir`` the system also mirrors it to the decoupled
on-disk layout (``write_lti_layout``, ``storage.DiskLTISearcher``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import pq as pqm
from .config import IndexConfig, PQConfig, resolve_device
from .graph import GraphState
from .index import build as mem_build
from .search import (FullPrecisionBackend, PQBackend, batch_distances,
                     beam_search, rerank_candidates, topk_results)


class LTIState(NamedTuple):
    graph: GraphState
    codes: torch.Tensor            # [capacity, m] uint8
    codebook: pqm.PQCodebook


def build_lti(vectors, cfg: IndexConfig, pq_cfg: PQConfig,
              train_sample: int = 65536, batch: int = 256,
              passes: int = 1, seed: int = 0,
              codebook: Optional[pqm.PQCodebook] = None,
              device="cuda") -> LTIState:
    """Static DiskANN-style build: graph from full-precision distances, a
    PQ codebook trained on the first ``train_sample`` points (or the given
    ``codebook``), every point encoded."""
    dev = resolve_device(device)
    graph = mem_build(vectors, cfg, batch=batch, passes=passes, seed=seed,
                      device=dev)
    n = vectors.shape[0]
    vecs = graph.vectors[:n]
    if codebook is None:
        codebook = pqm.train_pq(vecs[:min(n, train_sample)].float(), pq_cfg)
    else:
        cent = codebook.centroids
        if not isinstance(cent, torch.Tensor):
            cent = torch.from_numpy(np.array(cent, np.float32))
        codebook = pqm.PQCodebook(cent.float().to(dev))
    codes = torch.zeros((cfg.capacity, pq_cfg.m), dtype=torch.uint8,
                        device=dev)
    codes[:n] = pqm.encode(codebook, vecs, pq_cfg)
    return LTIState(graph, codes, codebook)


def search_lti(lti: LTIState, queries: torch.Tensor, cfg: IndexConfig, *,
               k: int, L: int, rerank: bool = True,
               beam_width: Optional[int] = None):
    """PQ-navigated beam search + exact rerank (paper §5.2 / DiskANN).
    Returns (ids [B,k], dists [B,k], hops [B], cmps [B])."""
    g = lti.graph
    use_kernel = cfg.kernel_enabled(g.device)
    res = beam_search(g.adjacency, g.active, g.start, queries,
                      PQBackend(lti.codes, lti.codebook),
                      L=L, max_visits=cfg.visits_bound(L),
                      beam_width=beam_width or cfg.beam_width,
                      use_kernel=use_kernel)
    reportable = g.active & ~g.deleted
    if rerank:
        # DeleteList members are masked BEFORE the gather: they can never
        # be reported, so their full-precision rows are not read.
        exact = batch_distances(
            FullPrecisionBackend(g.vectors), queries,
            rerank_candidates(res.ids, reportable), use_kernel=use_kernel)
        res = res._replace(dists=exact)
    ids, d = topk_results(res, k, reportable)
    return ids, d, res.n_hops, res.n_cmps


def write_lti_layout(path: str, lti: LTIState, *, ext_ids=None,
                     generation: int = 0):
    """Serialise an LTI into the decoupled on-disk layout (adjacency rows to
    ``topology.bin``, vectors and PQ codes to ``data.bin``, flags, ext ids
    and codebook to the side tables) and return it opened;
    ``storage.DiskLTISearcher`` over it equals ``search_lti`` on this
    state."""
    from ..storage.layout import write_layout
    return write_layout(path, lti.graph, codes=lti.codes,
                        codebook=lti.codebook, ext_ids=ext_ids,
                        generation=generation)


def lti_from_layout(path: str, device="cuda") -> LTIState:
    """The ``LTIState`` of a decoupled layout on ``device`` (recovery and
    tests; serving streams rows through ``storage.DiskSource``)."""
    from ..storage.layout import open_layout
    lay = open_layout(path)
    try:
        return lay.lti_state(device)
    finally:
        lay.close()
