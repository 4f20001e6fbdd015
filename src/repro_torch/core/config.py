"""Configuration objects for the FreshDiskANN core (PyTorch port).

The same three dataclasses as the JAX package's ``core/config.py``, with the
same fields and defaults, so one configuration describes both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Parameters of a FreshVamana graph index (paper §4, §6.1).

    Attributes:
      capacity: maximum number of slots (N_max).
      dim: vector dimensionality.
      R: maximum out-degree of the graph (paper: 64).
      L_build: candidate-list size during build/insert (paper: 75).
      L_search: default candidate-list size during search (paper: 100).
      alpha: the alpha-RNG pruning threshold (paper: 1.2).
      max_visits: cap on greedy-search expansions; 0 -> L + L//2 + 16.
      dtype: storage dtype of full-precision vectors.
      beam_width: W -- frontier nodes expanded per search round.
      use_kernel: route the hot paths through the kernel wrappers in
        ``repro_torch.kernels.ops``.  None (default): kernels for CUDA
        tensors, the plain engine path for CPU tensors.  True on the CPU
        runs the wrappers' plain versions (the numerics of the kernels);
        False on a CUDA device raises -- the plain path is a CPU reference.
      repair_mode: the delete-repair sweep, "global" (every block) or
        "local" (the affected rows only); both give the same graph.
      locality_clusters: medoids of the locality ordering
        (``SystemConfig.locality_order``).
    """

    capacity: int
    dim: int
    R: int = 64
    L_build: int = 75
    L_search: int = 100
    alpha: float = 1.2
    max_visits: int = 0
    dtype: str = "float32"
    beam_width: int = 1
    use_kernel: Optional[bool] = None
    repair_mode: str = "global"
    locality_clusters: int = 16

    def visits_bound(self, L: int) -> int:
        if self.max_visits:
            return self.max_visits
        return int(L + L // 2 + 16)

    def kernel_enabled(self, device) -> bool:
        """Resolve ``use_kernel`` for tensors on ``device``: kernels on a
        CUDA device, the plain engine path on the CPU."""
        if torch.device(device).type == "cuda":
            if self.use_kernel is False:
                raise ValueError("use_kernel=False on a CUDA device: the "
                                 "plain engine path runs on the CPU only")
            return True
        return bool(self.use_kernel)


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Product-quantization parameters (paper §5: 32 bytes/vector)."""

    dim: int
    m: int = 32
    ksub: int = 256
    kmeans_iters: int = 12
    seed: int = 0

    def __post_init__(self):
        if self.dim % self.m != 0:
            raise ValueError(f"dim={self.dim} not divisible by m={self.m}")

    @property
    def dsub(self) -> int:
        return self.dim // self.m


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """FreshDiskANN system-level knobs (paper §5, §6.2).  Field meanings are
    those of the JAX package's ``SystemConfig``, and the port runs every
    one of them."""

    index: IndexConfig
    pq: PQConfig
    ro_snapshot_points: int = 4096
    merge_threshold: int = 16384
    temp_capacity: int = 65536
    insert_batch: int = 256
    merge_block: int = 1024
    rerank: bool = True
    wal_dir: Optional[str] = None
    snapshot_dir: Optional[str] = None
    batch_fanout: bool = True
    batch_queries: int = 0
    shard_lti: int = 0
    background_merge: bool = False
    autotune_beam: bool = False
    beam_width_candidates: tuple = (1, 2, 4, 8)
    storage_dir: Optional[str] = None
    prefetch_depth: int = 1
    adjacency_cache_mb: int = 8
    local_repair_threshold: float = 0.05
    reach_probe_samples: int = 32
    reach_escalate_frac: float = 0.05
    locality_order: bool = False
    io_latency_us: float = 0.0
    slo_ms: float = 0.0
    serve_queue_capacity: int = 1024
    dispatch_estimate_ms: float = 1.0
    clock: Optional[object] = None
    filter_words: int = 0
    tenant_quota: int = 0


# The paper's operating point for the billion-scale deployment (§6.2).
PAPER_BILLION = IndexConfig(
    capacity=1_073_741_824, dim=128, R=64, L_build=75, L_search=100, alpha=1.2
)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (the default) and missing --
    the port never carries on silently on the CPU.  On CUDA it turns TF32
    off for the process (PyTorch's matmul default, and cuDNN's flag), and
    cuBLAS's bf16 reduced-precision reduction."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA is not available; the port runs on an "
                "NVIDIA GPU by default -- pass device='cpu' to run its CPU "
                "path")
        # The dense products (k-means assignment, medoid, brute force) must
        # run in full f32, as the reference's: TF32 would shift PQ codes.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # A bf16 matmul accumulates in f32 in the reference (XLA); cuBLAS's
        # reduced-precision split-K would add its partial sums in bf16.
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
    return dev
