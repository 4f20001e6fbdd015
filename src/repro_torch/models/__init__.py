"""Model families of the port.

  layers.py      — RMSNorm, RoPE, SwiGLU, chunked (flash) attention and
                   single-token decode attention: the decoder LMs'
                   building blocks (forward values).
  moe.py         — the MoE FFN: group-local top-k capacity dispatch
                   (``MoEConfig``, ``capacity``, ``moe_ffn``).
  transformer.py — the decoder LMs, dense (qwen3-14b, qwen2-1.5b,
                   gemma3-12b) and MoE (mixtral-8x7b, qwen3-moe-30b-a3b):
                   ``TransformerConfig``, parameters stacked per pattern
                   position, ``forward`` (prefill, with the KV caches),
                   ``lm_loss``, ring-buffer ``init_cache`` and
                   ``decode_step``.
  recsys.py      — EmbeddingBag, FM / DeepFM / xDeepFM (CIN) / SASRec: the
                   serving path (forward values), ported with the
                   retrieval integration it feeds.

The reference's other families wait for their slices (``ROADMAP.md``,
Queue 1): GraphSAGE (``gnn.py``), and every family's gradients for the
training slice.
"""
from . import layers, moe, recsys, transformer  # noqa: E402

__all__ = ["layers", "moe", "recsys", "transformer"]
