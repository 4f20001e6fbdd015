"""sasrec [recsys] — embed_dim=50 n_blocks=2 n_heads=1 seq_len=50,
self-attentive sequential recommendation.  [arXiv:1808.09781; paper]

The showcase FreshDiskANN integration: the encoder's final hidden state is
the retrieval query against the (streaming) item-embedding index -- the
``recsys`` phase of ``chip_smoke.py`` serves it through the port's
``FreshDiskANN``.
"""
from ..models.recsys import RecsysConfig
from .common import ArchSpec, recsys_cells

FULL = RecsysConfig(
    name="sasrec", kind="sasrec", embed_dim=50, n_items=1_048_576,
    seq_len=50, n_blocks=2, n_heads=1)

SMOKE = RecsysConfig(
    name="sasrec-smoke", kind="sasrec", embed_dim=16, n_items=512,
    seq_len=12, n_blocks=2, n_heads=1)

ARCH = ArchSpec("sasrec", "recsys", FULL, SMOKE, recsys_cells(FULL))
