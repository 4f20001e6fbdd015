"""graphsage-reddit [gnn] — 2 layers, d_hidden=128, mean aggregator,
sample sizes 25-10.  [arXiv:1706.02216; paper]

The four shapes span three datasets (cora-scale / reddit / ogbn-products /
batched molecules); d_feat and n_classes are per-shape (Cell.meta) and
``common.gnn_cell_config`` specialises the config per cell.
"""
from ..models.gnn import SageConfig
from .common import ArchSpec, gnn_cells

FULL = SageConfig(
    name="graphsage-reddit", d_feat=602, d_hidden=128, n_layers=2,
    n_classes=41, fanout=(25, 10), aggregator="mean")

SMOKE = SageConfig(
    name="graphsage-smoke", d_feat=16, d_hidden=32, n_layers=2,
    n_classes=7, fanout=(5, 3), aggregator="mean")

ARCH = ArchSpec("graphsage-reddit", "gnn", FULL, SMOKE, gnn_cells(FULL))
