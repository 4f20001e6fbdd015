"""fm [recsys] — n_sparse=39 embed_dim=10, pairwise FM interaction via the
O(nk) sum-square trick.  [ICDM'10 (Rendle); paper]"""
from ..models.recsys import RecsysConfig
from .common import ArchSpec, recsys_cells

FULL = RecsysConfig(
    name="fm", kind="fm", n_sparse=39, rows_per_field=1_048_576,
    embed_dim=10)

SMOKE = RecsysConfig(
    name="fm-smoke", kind="fm", n_sparse=5, rows_per_field=128,
    embed_dim=10)

ARCH = ArchSpec("fm", "recsys", FULL, SMOKE, recsys_cells(FULL))
