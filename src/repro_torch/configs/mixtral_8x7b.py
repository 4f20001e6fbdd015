"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]"""
from ..models.transformer import TransformerConfig
from .common import ArchSpec, lm_cells

FULL = TransformerConfig(
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_head=128, d_ff=0, vocab=32000, qk_norm=False,
    qkv_bias=False, rope_theta=1_000_000.0, window=4096, pattern=("l",),
    moe_experts=8, moe_top_k=2, moe_d_ff=14336, moe_groups=16,
    q_chunk=256, kv_chunk=256, dtype="bfloat16")

SMOKE = TransformerConfig(
    name="mixtral-8x7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=0, vocab=512, window=16, pattern=("l",),
    moe_experts=4, moe_top_k=2, moe_d_ff=96, moe_groups=4, moe_cf=4.0,
    q_chunk=16, kv_chunk=16, dtype="float32")

ARCH = ArchSpec("mixtral-8x7b", "lm", FULL, SMOKE, lm_cells(FULL))
