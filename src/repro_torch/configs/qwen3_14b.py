"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from ..models.transformer import TransformerConfig
from .common import ArchSpec, lm_cells

FULL = TransformerConfig(
    name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_head=128, d_ff=17408, vocab=151936, qk_norm=True, qkv_bias=False,
    rope_theta=1_000_000.0, pattern=("g",), q_chunk=256, kv_chunk=256,
    dtype="bfloat16")

SMOKE = TransformerConfig(
    name="qwen3-14b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=512, qk_norm=True, qkv_bias=False,
    pattern=("g",), q_chunk=16, kv_chunk=16, dtype="float32")

ARCH = ArchSpec("qwen3-14b", "lm", FULL, SMOKE, lm_cells(FULL))
