"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, GQA, QKV bias.  [arXiv:2407.10671; hf]"""
from ..models.transformer import TransformerConfig
from .common import ArchSpec, lm_cells

FULL = TransformerConfig(
    name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_head=128, d_ff=8960, vocab=151936, qk_norm=False, qkv_bias=True,
    rope_theta=1_000_000.0, pattern=("g",), q_chunk=256, kv_chunk=256,
    dtype="bfloat16")

SMOKE = TransformerConfig(
    name="qwen2-1.5b-smoke", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
    d_head=12, d_ff=96, vocab=512, qk_norm=False, qkv_bias=True,
    pattern=("g",), q_chunk=16, kv_chunk=16, dtype="float32")

ARCH = ArchSpec("qwen2-1.5b", "lm", FULL, SMOKE, lm_cells(FULL))
