"""Synthetic data streams of the port (its own copy of the JAX package's
``data/pipelines.py`` streams that the ANN serving entry point and the
recsys models use)."""
from .pipelines import click_stream, sasrec_stream, vector_stream

__all__ = ["click_stream", "sasrec_stream", "vector_stream"]
