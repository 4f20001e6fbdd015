"""freshdiskann-1b — the paper's own billion-point operating point (§6.2),
pod-scaled: 2M points/chip x 512 chips ~ 1.05B points, R=64, L=75/100,
alpha=1.2, PQ-32.  The LTI is split into independent sub-indices (the
paper's own trillion-point distribution design, §1); queries broadcast,
results top-k-merged (``launch/ann_steps.py``).

Its cells are records of the dry-run shapes (search / insert / merge
phases); the reference's XLA dry-run tools that read them are not ported.
"""
import dataclasses

import torch

from ..core.config import IndexConfig, PQConfig
from .common import ArchSpec, Cell, S


@dataclasses.dataclass(frozen=True)
class AnnDeployment:
    name: str
    points_per_shard: int
    dim: int
    index: IndexConfig
    pq: PQConfig
    query_batch: int
    insert_batch: int
    k: int = 5


FULL = AnnDeployment(
    name="freshdiskann-1b",
    points_per_shard=2_097_152,          # x512 chips = 1.07B points
    dim=128,
    # beam_width=4: each search round issues 4 concurrent adjacency reads
    # (§6.2 beamwidth) -- ~4x fewer IO rounds per query at equal recall.
    index=IndexConfig(capacity=2_097_152, dim=128, R=64, L_build=75,
                      L_search=100, alpha=1.2, beam_width=4),
    pq=PQConfig(dim=128, m=32, ksub=256),
    query_batch=1024,                    # global concurrent queries
    insert_batch=4096,                   # staged inserts per merge chunk
)

SMOKE = AnnDeployment(
    name="freshdiskann-smoke",
    points_per_shard=1024,
    dim=32,
    index=IndexConfig(capacity=1024, dim=32, R=16, L_build=24, L_search=32,
                      alpha=1.2, max_visits=48),
    pq=PQConfig(dim=32, m=8, ksub=32, kmeans_iters=4),
    query_batch=8,
    insert_batch=32,
)


def _search_specs():
    c = FULL
    return {"queries": S((c.query_batch, c.dim), torch.float32)}


def _insert_specs():
    c = FULL
    return {"new_vecs": S((c.insert_batch, c.dim), torch.float32)}


def _merge_specs():
    c = FULL
    return {
        "new_vecs": S((c.insert_batch, c.dim), torch.float32),
        "new_valid": S((c.insert_batch,), torch.bool),
        "delete_mask": S((c.index.capacity,), torch.bool),
    }


ARCH = ArchSpec(
    "freshdiskann-1b", "ann", FULL, SMOKE,
    [
        Cell("search_1b", "ann_search", _search_specs,
             {"points": FULL.points_per_shard}),
        Cell("insert_1b", "ann_insert", _insert_specs, {}),
        Cell("merge_1b", "ann_merge", _merge_specs, {}),
    ])
