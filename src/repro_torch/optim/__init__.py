"""Optimizers of the port: AdamW (``adamw``, plain or over ZeRO-3 sharded
parameters) and the compressed gradient all-reduces (``compress``: bf16
and int8 over the data shards' gradient trees)."""
from .adamw import AdamWState, adamw_init, adamw_update
from .compress import (bf16_all_reduce, int8_all_gather_reduce,
                       int8_all_reduce, int8_compress, int8_compress_noise,
                       int8_decompress)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "bf16_all_reduce",
           "int8_all_gather_reduce", "int8_all_reduce", "int8_compress",
           "int8_compress_noise", "int8_decompress"]
