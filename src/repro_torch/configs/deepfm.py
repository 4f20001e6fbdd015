"""deepfm [recsys] — n_sparse=39 embed_dim=10 mlp=400-400-400,
FM interaction + shared-embedding DNN.  [arXiv:1703.04247; paper]"""
from ..models.recsys import RecsysConfig
from .common import ArchSpec, recsys_cells

FULL = RecsysConfig(
    name="deepfm", kind="deepfm", n_sparse=39, rows_per_field=1_048_576,
    embed_dim=10, mlp=(400, 400, 400))

SMOKE = RecsysConfig(
    name="deepfm-smoke", kind="deepfm", n_sparse=5, rows_per_field=128,
    embed_dim=10, mlp=(32, 32, 32))

ARCH = ArchSpec("deepfm", "recsys", FULL, SMOKE, recsys_cells(FULL))
