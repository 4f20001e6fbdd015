"""Deterministic synthetic vector streams: the port's own copy of
``vector_stream`` from the JAX package's ``data/pipelines.py`` (numpy
only), the ANN index's update and query stream.  Every batch is a pure
function of (seed, step), so the same seed yields the reference's vectors.
The model streams of that module belong to its model scaffolding and are
not ported.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def vector_stream(batch: int, dim: int, n_clusters: int = 64, seed: int = 0,
                  start_step: int = 0) -> Iterator[np.ndarray]:
    """Gaussian-mixture vectors, ``batch`` rows of ``dim`` per step."""
    centers = _rng(seed, 0).standard_normal((n_clusters, dim)) * 3.0
    step = start_step
    while True:
        r = _rng(seed, step)
        which = r.integers(0, n_clusters, batch)
        yield (centers[which]
               + r.standard_normal((batch, dim))).astype(np.float32)
        step += 1
