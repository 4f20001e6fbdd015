"""Model families of the port.

  layers.py      — RMSNorm, RoPE, SwiGLU, chunked (flash) attention (with
                   its FlashAttention-2 backward) and single-token decode
                   attention: the decoder LMs' building blocks.
  moe.py         — the MoE FFN: group-local top-k capacity dispatch
                   (``MoEConfig``, ``capacity``, ``moe_ffn``).
  transformer.py — the decoder LMs, dense (qwen3-14b, qwen2-1.5b,
                   gemma3-12b) and MoE (mixtral-8x7b, qwen3-moe-30b-a3b):
                   ``TransformerConfig``, parameters stacked per pattern
                   position, ``forward`` (prefill, with the KV caches),
                   ``lm_loss``, ring-buffer ``init_cache`` and
                   ``decode_step``.
  recsys.py      — EmbeddingBag, FM / DeepFM / xDeepFM (CIN) / SASRec: the
                   serving path and the losses' gradients, ported with
                   the retrieval integration it feeds.
  gnn.py         — GraphSAGE: full-batch, sampled and batched forwards and
                   losses over ``SegmentMean``, the chunked segment mean
                   with its own backward, and the fanout sampler.

Every family's loss is differentiable, the MoE dispatch's included
(``launch/train.py`` trains them).
"""
from . import gnn, layers, moe, recsys, transformer  # noqa: E402

__all__ = ["gnn", "layers", "moe", "recsys", "transformer"]
