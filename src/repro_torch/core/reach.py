"""Reachability monitor: a sampled probe of unreachable live points
(PyTorch port of ``core/reach.py``).

``unreachable_fraction`` samples live points, beam-searches each one's own
vector from the entry point, and counts a point unreachable when its slot
is in neither the result list nor the visited set.  A healthy Vamana graph
self-navigates, so the estimate is ~0 on intact graphs and grows as repair
quality degrades.  The system reads it as the ``unreachable_frac`` gauge
and escalates a localized repair to the global sweep when the estimate
rises more than ``SystemConfig.reach_escalate_frac`` above the baseline of
the last global sweep.  The picks are drawn with ``numpy`` from the seed,
as in the reference, so both packages probe the same slots.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import IndexConfig
from .graph import GraphState
from .search import FullPrecisionBackend, beam_search


def unreachable_fraction(state: GraphState, cfg: IndexConfig,
                         samples: int = 32, seed: int = 0,
                         L: int | None = None) -> float:
    """Estimate the fraction of live points greedy search cannot reach.

    Draws exactly ``samples`` live slots (with replacement when fewer live
    points exist) and searches each one's own vector from ``state.start``.
    Returns 0.0 for an empty index and 1.0 when live points exist but the
    entry point is the empty sentinel."""
    live_ids = np.nonzero((state.active & ~state.deleted).cpu().numpy())[0]
    if len(live_ids) == 0 or samples <= 0:
        return 0.0
    if int(state.start) < 0:
        return 1.0
    rng = np.random.default_rng(seed)
    picks = rng.choice(live_ids, size=int(samples),
                       replace=len(live_ids) < int(samples)).astype(np.int32)
    L = cfg.L_search if L is None else L
    p = torch.as_tensor(picks).to(state.device)
    res = beam_search(state.adjacency, state.active, state.start,
                      state.vectors[p.long()],
                      FullPrecisionBackend(state.vectors), L=L,
                      max_visits=cfg.visits_bound(L),
                      beam_width=cfg.beam_width,
                      use_kernel=cfg.kernel_enabled(state.device))
    seen = torch.cat([res.ids, res.visited], 1)
    found = (seen == p[:, None]).any(1)
    return float(1.0 - found.float().mean())
