"""Optimizers of the port: AdamW (``adamw``).  The reference's gradient
compression (``optim/compress.py``) is multi-card and waits for the
model-sharding slice."""
from .adamw import AdamWState, adamw_init, adamw_update

__all__ = ["AdamWState", "adamw_init", "adamw_update"]
