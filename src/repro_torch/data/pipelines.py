"""Deterministic synthetic data streams: the port's own copy of the JAX
package's ``data/pipelines.py`` streams that the port serves (numpy only).
Every batch is a pure function of (seed, step), so the same seed yields
the reference's arrays byte for byte.

* ``vector_stream``: the ANN index's update and query stream;
* ``click_stream``: the FM family's Criteo-like click batches;
* ``sasrec_stream``: SASRec's item sequences and BPR negatives.

``lm_token_stream`` and ``synthetic_graph`` wait for the LM and GraphSAGE
slices (``ROADMAP.md``, Queue 1).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def click_stream(batch: int, n_sparse: int, rows_per_field: int,
                 seed: int = 0, start_step: int = 0) -> Iterator[dict]:
    """Criteo-like categorical click stream with a planted logistic signal:
    ``ids`` int32 [batch, n_sparse], already offset per field, and
    ``labels`` int32 [batch]."""
    step = start_step
    w = _rng(seed, 0).standard_normal(n_sparse)
    while True:
        r = _rng(seed, step)
        ids = r.integers(0, rows_per_field, (batch, n_sparse))
        logit = ((ids % 7 - 3) * w).sum(axis=1) / np.sqrt(n_sparse)
        y = (r.random(batch) < 1 / (1 + np.exp(-logit))).astype(np.int32)
        offset = np.arange(n_sparse) * rows_per_field
        yield {"ids": (ids + offset).astype(np.int32), "labels": y}
        step += 1


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


def sasrec_stream(batch: int, seq_len: int, n_items: int, seed: int = 0,
                  start_step: int = 0) -> Iterator[dict]:
    """Markov-chain item sequences (learnable transitions) with BPR
    negatives: ``seq``, ``pos`` and ``neg``, int32 [batch, seq_len]; item
    0 is padding and never drawn."""
    step = start_step
    while True:
        r = _rng(seed, step)
        seq = np.zeros((batch, seq_len + 1), np.int64)
        seq[:, 0] = r.integers(1, n_items, batch)
        for t in range(seq_len):
            nxt = (seq[:, t] * 17 + 3) % (n_items - 1) + 1
            noise = r.integers(1, n_items, batch)
            take_noise = r.random(batch) < 0.3
            seq[:, t + 1] = np.where(take_noise, noise, nxt)
        neg = r.integers(1, n_items, (batch, seq_len))
        yield {"seq": seq[:, :-1].astype(np.int32),
               "pos": seq[:, 1:].astype(np.int32),
               "neg": neg.astype(np.int32)}
        step += 1
