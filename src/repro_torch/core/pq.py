"""Product quantization: codebook training, encode, decode, LUTs, ADC and
SDC tables (the PyTorch counterpart of the JAX package's ``core/pq.py``).

``train_pq`` draws its initial centroids from a ``torch.Generator`` seeded
with ``PQConfig.seed``; those are not ``jax.random``'s draws, so parity
tests hand both packages the reference's codebook instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import PQConfig

# Rows encoded per step: [rows, m, ksub] f32 scores stay ~1 GiB at m=32,
# ksub=256 (the JAX program encodes in one step and lets XLA tile it).
_ENCODE_ROWS = 32768


class PQCodebook(NamedTuple):
    centroids: torch.Tensor   # [m, ksub, dsub] float32


def _assign(x_sub: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """x_sub [N, m, dsub], cent [m, ksub, dsub] -> codes [N, m] int64."""
    xc = torch.einsum("nmd,mkd->nmk", x_sub, cent)
    cn = (cent * cent).sum(-1)                               # [m, ksub]
    return torch.argmin(cn[None] - 2.0 * xc, dim=-1)


def train_pq(data: torch.Tensor, cfg: PQConfig,
             generator: torch.Generator | None = None) -> PQCodebook:
    """Lloyd's k-means per subspace (vectorised across all m subspaces)."""
    n = data.shape[0]
    dev = data.device
    x = data.float().reshape(n, cfg.m, cfg.dsub)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(cfg.seed)
    if n < cfg.ksub:
        init = torch.randint(0, n, (cfg.ksub,), generator=generator,
                             device=dev)
    else:
        init = torch.randperm(n, generator=generator, device=dev)[:cfg.ksub]
    cent = x[init].permute(1, 0, 2).contiguous()             # [m, ksub, dsub]
    ar = torch.arange(cfg.m, device=dev)
    for _ in range(cfg.kmeans_iters):
        codes = _assign(x, cent)                             # [N, m]
        flat = (ar[None, :] * cfg.ksub + codes).reshape(-1)  # [N*m]
        sums = torch.zeros((cfg.m * cfg.ksub, cfg.dsub), device=dev)
        sums.index_add_(0, flat, x.reshape(-1, cfg.dsub))
        cnts = torch.bincount(flat, minlength=cfg.m * cfg.ksub).float()
        sums = sums.reshape(cfg.m, cfg.ksub, cfg.dsub)
        cnts = cnts.reshape(cfg.m, cfg.ksub)
        new = sums / cnts.clamp(min=1.0)[..., None]
        cent = torch.where((cnts > 0)[..., None], new, cent)  # keep empty
    return PQCodebook(cent)


def encode(codebook: PQCodebook, data: torch.Tensor,
           cfg: PQConfig) -> torch.Tensor:
    """Vectors -> uint8 codes [N, m] (in row chunks)."""
    n = data.shape[0]
    out = torch.empty((n, cfg.m), dtype=torch.uint8, device=data.device)
    for lo in range(0, n, _ENCODE_ROWS):
        x = data[lo:lo + _ENCODE_ROWS].float().reshape(-1, cfg.m, cfg.dsub)
        out[lo:lo + _ENCODE_ROWS] = _assign(x, codebook.centroids).to(
            torch.uint8)
    return out


def decode(codebook: PQCodebook, codes: torch.Tensor,
           cfg: PQConfig) -> torch.Tensor:
    """Codes -> reconstructed vectors [N, dim]."""
    c = codes.long()                                         # [N, m]
    ar = torch.arange(cfg.m, device=codes.device)
    recon = codebook.centroids[ar[None, :], c]               # [N, m, dsub]
    return recon.reshape(codes.shape[0], cfg.m * cfg.dsub)


def lut(codebook: PQCodebook, query: torch.Tensor) -> torch.Tensor:
    """ADC lookup tables of squared subspace distances: query [..., dim] ->
    [..., m, ksub] (one table per query row)."""
    m, ksub, dsub = codebook.centroids.shape
    q = query.float().reshape(*query.shape[:-1], m, 1, dsub)
    diff = q - codebook.centroids
    return (diff * diff).sum(-1)


def adc(codes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ADC: ``sum_m table[m, codes[:, m]]`` -> [N] (plain path)."""
    m = table.shape[0]
    ar = torch.arange(m, device=table.device)
    return table[ar[None, :], codes.long()].sum(-1)


def adc_gather(codes: torch.Tensor, tables: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """ADC of rows ``ids`` [B, K] against per-row tables [B, m, ksub]
    (each row's sum over m of ``tables[b, m, codes[id, m]]``); INVALID ids
    -> +inf.  The plain engine path of the LTI lane."""
    B, m, ksub = tables.shape
    K = ids.shape[1]
    c = codes[ids.clamp(min=0).long()].long()                # [B, K, m]
    flat = c + (torch.arange(m, device=c.device) * ksub)[None, None, :]
    g = torch.gather(tables.reshape(B, m * ksub), 1,
                     flat.reshape(B, K * m)).reshape(B, K, m)
    d = g.sum(-1)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def sdc_tables(codebook: PQCodebook) -> torch.Tensor:
    """Centroid-pair squared distances [m, ksub, ksub]."""
    c = codebook.centroids
    diff = c[:, :, None, :] - c[:, None, :, :]
    return (diff * diff).sum(-1)


def sdc_lut(tables: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Anchor PQ codes: code [..., m] -> ADC-shaped LUTs [..., m, ksub]
    (``tables[j, code[..., j], :]``), so that ``adc(codes_b,
    sdc_lut(tables, a))`` is the SDC distance from a to every b."""
    m = tables.shape[0]
    return tables[torch.arange(m, device=tables.device), code.long()]
