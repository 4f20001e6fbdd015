"""Beam-width autotuning -- pick W from the measured hop/cmp trade-off (the
PyTorch port's own copy of the JAX package's ``core/autotune.py``, which
needs only numpy).

The paper's §6.2 beamwidth argument: each search iteration issues W
concurrent sector reads as ONE IO round, so raising W cuts the number of
rounds (latency) about W-fold while paying a few extra distance
computations.  The right W depends on the ratio between the cost of an IO
round and the cost of a distance computation, a property of the serving
hardware, not of the index.

``measure_widths`` runs a probe batch at each candidate W and records the
per-query hop/cmp counters; ``pick_beam_width`` scores each point under a
linear cost model and returns the argmin.  The model is counter-based
(hops and cmps are deterministic), so the choice is reproducible and
immune to wall-clock noise.

``FreshDiskANN`` wires this in behind ``SystemConfig.autotune_beam``: the
first search calibrates and caches the width; a StreamingMerge or a
consolidation invalidates the cache.  With ``batch_fanout`` the probe runs
the unified fan-out itself (``index.unified_search``): per-query IO rounds
are the max over lanes, distance computations the sum over lanes.  Sharded
and replicated serving return the same counters, so one probe calibrates
every serving configuration of the same tier census.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class BeamCostModel:
    """Relative cost of one IO round vs one distance computation.

    The defaults encode the paper's SSD regime (~100us random read vs ~0.4us
    for a handful of ADC lookups): an IO round costs ~250 comparisons.  On
    hardware where distance evaluation dominates (e.g. full-precision scoring
    on CPU), raise ``cmp_cost`` and the tuner will back off to smaller W.
    """

    io_round_cost: float = 1.0
    cmp_cost: float = 0.004


@dataclasses.dataclass(frozen=True)
class BeamPoint:
    """One measured operating point of the beam-width sweep."""

    W: int
    hops: float         # mean IO rounds per query
    cmps: float         # mean distance computations per query
    seconds: float = 0.0  # wall-clock of the probe (informational only)

    def cost(self, model: BeamCostModel) -> float:
        return self.hops * model.io_round_cost + self.cmps * model.cmp_cost


def measure_widths(search_fn: Callable[[int], tuple],
                   widths: Sequence[int]) -> list[BeamPoint]:
    """Probe ``search_fn(W) -> (hops [B], cmps [B])`` at each candidate W."""
    points = []
    for W in widths:
        t0 = time.perf_counter()
        hops, cmps = search_fn(W)
        points.append(BeamPoint(
            W=int(W), hops=float(np.mean(np.asarray(hops))),
            cmps=float(np.mean(np.asarray(cmps))),
            seconds=time.perf_counter() - t0))
    return points


def pick_beam_width(points: Sequence[BeamPoint],
                    model: BeamCostModel = BeamCostModel()) -> int:
    """The W minimizing the modeled per-query cost (ties -> smallest W)."""
    if not points:
        raise ValueError("empty beam-width sweep")
    best = min(points, key=lambda p: (p.cost(model), p.W))
    return best.W
