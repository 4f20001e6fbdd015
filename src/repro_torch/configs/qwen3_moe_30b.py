"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) moe_d_ff=768
vocab=151936, MoE 128 experts top-8, qk-norm.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from ..models.transformer import TransformerConfig
from .common import ArchSpec, lm_cells

FULL = TransformerConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, d_head=128, d_ff=0, vocab=151936, qk_norm=True,
    qkv_bias=False, rope_theta=1_000_000.0, pattern=("g",),
    moe_experts=128, moe_top_k=8, moe_d_ff=768, moe_groups=16,
    q_chunk=256, kv_chunk=256, dtype="bfloat16")

SMOKE = TransformerConfig(
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=0, vocab=512, qk_norm=True, pattern=("g",),
    moe_experts=8, moe_top_k=2, moe_d_ff=64, moe_groups=4, moe_cf=4.0,
    q_chunk=16, kv_chunk=16, dtype="float32")

ARCH = ArchSpec("qwen3-moe-30b-a3b", "lm", FULL, SMOKE, lm_cells(FULL))
