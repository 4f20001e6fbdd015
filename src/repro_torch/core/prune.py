"""RobustPrune (Algorithm 3) -- the alpha-RNG pruning rule, as an engine.

An edge to c is dropped once some retained p* satisfies
``alpha * d(p*, c) <= d(p, c)``.  ``robust_prune_batch`` prunes a whole
block of node rows per call through a prune backend:

  ``FullPrecisionPrune``  exact squared L2 over a stored vector table; its
                          rounds run in the ``robust_prune_fp`` kernel when
                          ``use_kernel`` and in its plain version otherwise;
  ``SDCPrune``            symmetric distances straight from PQ codes (the
                          StreamingMerge operating point, ``use_sdc``); its
                          rounds run in ``robust_prune_sdc``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import pq as pqm
from .distance import l2_sq
from ..kernels import ops


class PruneResult(NamedTuple):
    ids: torch.Tensor    # [B, R] INVALID padded
    count: torch.Tensor  # [B] int32


class FullPrecisionPrune(NamedTuple):
    """Exact squared-L2 pruning against a stored table ([N, d])."""

    table: torch.Tensor

    def anchor_of(self, ps: torch.Tensor) -> torch.Tensor:
        return self.table[ps.clamp(min=0).long()].float()

    def anchor_dists(self, anchors: torch.Tensor, cand_ids: torch.Tensor
                     ) -> torch.Tensor:
        """anchors [B, d] x cand_ids [B, C] -> raw d(p, c) [B, C]."""
        return l2_sq(anchors[:, None, :],
                     self.table[cand_ids.clamp(min=0).long()])

    def prune_rows(self, d_p, cand_ids, cand_ok, *, alpha, R, use_kernel
                   ) -> PruneResult:
        out, cnt = ops.robust_prune_fp(
            d_p.float().contiguous(), self.table.float().contiguous(),
            cand_ids.int().contiguous(), cand_ok.contiguous(), alpha=alpha,
            R=R, use_kernel=use_kernel)
        return PruneResult(out, cnt)


class SDCPrune(NamedTuple):
    """PQ-code pruning: every distance is symmetric-distance-computed from
    ``codes`` [N, m] uint8 through ``tables`` [m, ksub, ksub]
    (``pq.sdc_tables``) -- equal to pruning on the decoded vectors."""

    codes: torch.Tensor
    tables: torch.Tensor

    def anchor_of(self, ps: torch.Tensor) -> torch.Tensor:
        """Node ids [B] -> their SDC LUTs [B, m, ksub]."""
        return pqm.sdc_lut(self.tables, self.codes[ps.clamp(min=0).long()])

    def anchor_dists(self, anchors: torch.Tensor, cand_ids: torch.Tensor
                     ) -> torch.Tensor:
        """LUTs [B, m, ksub] x cand_ids [B, C] -> d(p, c) [B, C] (+inf
        where cand_ids < 0; those lanes are masked anyway)."""
        return pqm.adc_gather(self.codes, anchors.float(), cand_ids)

    def prune_rows(self, d_p, cand_ids, cand_ok, *, alpha, R, use_kernel
                   ) -> PruneResult:
        out, cnt = ops.robust_prune_sdc(
            d_p.float().contiguous(), self.codes, self.tables.float(),
            cand_ids.int().contiguous(), cand_ok.contiguous(), alpha=alpha,
            R=R, use_kernel=use_kernel)
        return PruneResult(out, cnt)


def robust_prune_batch(backend, cand_ids: torch.Tensor,
                       cand_ok: torch.Tensor, *, alpha: float, R: int,
                       use_kernel: bool = False, anchors=None,
                       d_p: torch.Tensor | None = None) -> PruneResult:
    """Row-batched Algorithm 3.  Anchor distances come from ``d_p`` when
    given, else from ``backend.anchor_dists(anchors, cand_ids)``."""
    if d_p is None:
        d_p = backend.anchor_dists(anchors, cand_ids)
    return backend.prune_rows(d_p, cand_ids, cand_ok, alpha=alpha, R=R,
                              use_kernel=use_kernel)


def prune_node_batch(backend, ps: torch.Tensor, cand_ids: torch.Tensor,
                     usable: torch.Tensor, *, alpha: float, R: int,
                     use_kernel: bool = False) -> PruneResult:
    """Prune stored nodes ``ps`` [B]: candidates must be valid, usable and
    not the node itself."""
    safe = cand_ids.clamp(min=0).long()
    ok = (cand_ids >= 0) & usable[safe] & (cand_ids != ps[:, None])
    return robust_prune_batch(backend, cand_ids, ok, alpha=alpha, R=R,
                              use_kernel=use_kernel,
                              anchors=backend.anchor_of(ps))


def check_alpha_rng(adj_row: torch.Tensor, p_vec: torch.Tensor,
                    vectors: torch.Tensor, alpha: float) -> torch.Tensor:
    """True when no retained edge is alpha-covered by an earlier one."""
    return _alpha_rng(adj_row[None], p_vec[None], vectors, alpha)[0]


def check_alpha_rng_rows(adjacency: torch.Tensor, node_ids: torch.Tensor,
                         vectors: torch.Tensor, alpha: float
                         ) -> torch.Tensor:
    """Per-row alpha-RNG verdicts for ``adjacency[node_ids]`` against the
    anchors ``vectors[node_ids]`` -> bool [len(node_ids)]."""
    safe = node_ids.clamp(min=0).long()
    return _alpha_rng(adjacency[safe], vectors[safe], vectors, alpha)


def _alpha_rng(adjacency: torch.Tensor, anchors: torch.Tensor,
               vectors: torch.Tensor, alpha: float) -> torch.Tensor:
    """Rows [n, R] with their anchor vectors [n, d] -> bool [n]."""
    R = adjacency.shape[1]
    vecs = vectors[adjacency.clamp(min=0).long()].float()    # [n, R, d]
    valid = adjacency >= 0
    d_p = torch.where(valid, l2_sq(anchors[:, None, :].float(), vecs),
                      torch.full(valid.shape, float("inf"),
                                 device=vecs.device))
    order = torch.sort(d_p, dim=1, stable=True).indices
    vecs_o = torch.gather(vecs, 1, order[..., None].expand_as(vecs))
    d_o = d_p.gather(1, order)
    valid_o = valid.gather(1, order)
    pair = l2_sq(vecs_o[:, :, None, :], vecs_o[:, None, :, :])  # [n, R, R]
    earlier = torch.tril(torch.ones((R, R), dtype=torch.bool,
                                    device=vecs.device), diagonal=-1)
    both = valid_o[:, :, None] & valid_o[:, None, :] & earlier[None]
    viol = (both & (alpha * pair.transpose(1, 2) <= d_o[:, :, None])
            & torch.isfinite(d_o)[:, :, None])
    return ~viol.flatten(1).any(1)
