"""Model families of the port.

  layers.py      — RMSNorm, RoPE, SwiGLU, chunked (flash) attention and
                   single-token decode attention: the decoder LMs'
                   building blocks (forward values).
  transformer.py — the dense decoder LMs (qwen3-14b, qwen2-1.5b,
                   gemma3-12b): ``TransformerConfig``, parameters stacked
                   per pattern position, ``forward`` (prefill, with the KV
                   caches), ``lm_loss``, ring-buffer ``init_cache`` and
                   ``decode_step``.
  recsys.py      — EmbeddingBag, FM / DeepFM / xDeepFM (CIN) / SASRec: the
                   serving path (forward values), ported with the
                   retrieval integration it feeds.

The reference's other families wait for their slices (``ROADMAP.md``,
Queue 1): the MoE FFN (``moe.py``, item 5b) for mixtral-8x7b and
qwen3-moe-30b-a3b, GraphSAGE (``gnn.py``) after it, and every family's
gradients for the training slice.
"""
from . import layers, recsys, transformer  # noqa: E402

__all__ = ["layers", "recsys", "transformer"]
