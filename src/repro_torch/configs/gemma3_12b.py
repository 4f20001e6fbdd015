"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global (window 1024), 128k context, qk-norm,
d_head=256.  [hf:google/gemma-3-1b-pt; unverified]"""
from ..models.transformer import TransformerConfig
from .common import ArchSpec, lm_cells

FULL = TransformerConfig(
    name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_head=256, d_ff=15360, vocab=262144, qk_norm=True, qkv_bias=False,
    rope_theta=1_000_000.0, window=1024,
    pattern=("l", "l", "l", "l", "l", "g"), q_chunk=256,
    kv_chunk=256, dtype="bfloat16")

SMOKE = TransformerConfig(
    name="gemma3-12b-smoke", n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=512, qk_norm=True, window=8,
    pattern=("l", "l", "l", "l", "l", "g"), q_chunk=16, kv_chunk=16,
    dtype="float32")

ARCH = ArchSpec("gemma3-12b", "lm", FULL, SMOKE, lm_cells(FULL))
