"""Synthetic data streams of the port (its own copy of the JAX package's
``data/pipelines.py`` stream that the serving driver uses)."""
from .pipelines import vector_stream

__all__ = ["vector_stream"]
