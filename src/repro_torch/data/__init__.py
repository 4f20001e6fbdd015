"""Synthetic data streams of the port (its own copy of the JAX package's
``data/pipelines.py`` streams that the ANN serving entry point, the recsys
models, the decoder LMs and GraphSAGE use)."""
from .pipelines import (click_stream, lm_token_stream, sasrec_stream,
                        synthetic_graph, vector_stream)

__all__ = ["click_stream", "lm_token_stream", "sasrec_stream",
           "synthetic_graph", "vector_stream"]
