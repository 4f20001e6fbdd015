"""xdeepfm [recsys] — n_sparse=39 embed_dim=10 cin_layers=200-200-200
mlp=400-400, CIN interaction.  [arXiv:1803.05170; paper]"""
from ..models.recsys import RecsysConfig
from .common import ArchSpec, recsys_cells

FULL = RecsysConfig(
    name="xdeepfm", kind="xdeepfm", n_sparse=39, rows_per_field=1_048_576,
    embed_dim=10, mlp=(400, 400), cin_layers=(200, 200, 200))

SMOKE = RecsysConfig(
    name="xdeepfm-smoke", kind="xdeepfm", n_sparse=5, rows_per_field=128,
    embed_dim=10, mlp=(32, 32), cin_layers=(8, 8, 8))

ARCH = ArchSpec("xdeepfm", "recsys", FULL, SMOKE, recsys_cells(FULL))
