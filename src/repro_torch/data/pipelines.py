"""Deterministic synthetic data streams: the port's own copy of the JAX
package's ``data/pipelines.py`` streams that the port serves (numpy only).
Every batch is a pure function of (seed, step), so the same seed yields
the reference's arrays byte for byte.

* ``vector_stream``: the ANN index's update and query stream;
* ``click_stream``: the FM family's Criteo-like click batches;
* ``sasrec_stream``: SASRec's item sequences and BPR negatives;
* ``lm_token_stream``: the decoder LMs' token batches;
* ``synthetic_graph``: GraphSAGE's graphs (CSR, features, labels).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def lm_token_stream(batch: int, seq_len: int, vocab: int, seed: int = 0,
                    start_step: int = 0) -> Iterator[dict]:
    """Zipf-ish token stream with local correlations: ``tokens`` and
    ``targets`` (the next token; the last one (token * 31 + 7) mod the
    range), int32 [batch, seq_len], ids in [1, vocab - 2]."""
    step = start_step
    while True:
        r = _rng(seed, step)
        base = r.zipf(1.3, size=(batch, seq_len)).astype(np.int64)
        tokens = (base % (vocab - 2)) + 1
        targets = np.roll(tokens, -1, axis=1)
        targets[:, -1] = (tokens[:, -1] * 31 + 7) % (vocab - 2) + 1
        yield {"tokens": tokens.astype(np.int32),
               "targets": targets.astype(np.int32)}
        step += 1


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


def _stable_order(keys: np.ndarray, n_keys: int) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for keys in [0, n_keys): one
    sort of the distinct values ``key * len + position`` (an order of
    magnitude faster than the stable argsort at 10M keys), the same
    permutation."""
    n = len(keys)
    if n == 0 or n_keys * n >= 2**63:
        return np.argsort(keys, kind="stable")
    order = keys.astype(np.int64) * n + np.arange(n)
    order.sort()
    return order % n


def synthetic_graph(n_nodes: int, avg_degree: int, d_feat: int,
                    n_classes: int, seed: int = 0):
    """Power-law-ish random graph in CSR + homophilous features/labels:
    ``feats`` f32 [N, d_feat], ``labels``, ``src``, ``dst`` (edge list)
    and ``nbrs`` (``src`` ordered stably by ``dst``) int32, ``offsets``
    int32 [N + 1].  The in-degrees are counted with ``np.bincount`` where
    the reference adds them one by one (``np.add.at``), and the order by
    ``dst`` is ``_stable_order``'s: the same bytes, and seconds instead
    of tens of them at a hundred million edges."""
    r = _rng(seed, 0)
    n_edges = n_nodes * avg_degree
    src = r.integers(0, n_nodes, n_edges)
    dst = (src + r.zipf(1.5, n_edges)) % n_nodes   # locality-biased targets
    labels = r.integers(0, n_classes, n_nodes)
    feats = r.standard_normal((n_nodes, d_feat)).astype(np.float32)
    feats[:, 0] += labels                          # learnable signal
    order = _stable_order(dst, n_nodes)
    src_sorted = src[order].astype(np.int32)
    offsets = np.zeros(n_nodes + 1, np.int64)
    offsets[1:] = np.cumsum(np.bincount(dst, minlength=n_nodes))
    return {
        "feats": feats, "labels": labels.astype(np.int32),
        "src": src.astype(np.int32), "dst": dst.astype(np.int32),
        "offsets": offsets.astype(np.int32), "nbrs": src_sorted,
    }


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
