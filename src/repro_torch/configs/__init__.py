"""Architecture registry of the port: ``get_arch(name)`` /
``list_archs()`` over every arch of the reference -- the decoder LMs
(dense and MoE), the recsys family, GraphSAGE -- and the paper's own
billion-point deployment config (``freshdiskann-1b``).
"""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen3-14b": "qwen3_14b",
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma3-12b": "gemma3_12b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "graphsage-reddit": "graphsage_reddit",
    "fm": "fm",
    "xdeepfm": "xdeepfm",
    "sasrec": "sasrec",
    "deepfm": "deepfm",
    "freshdiskann-1b": "freshdiskann_1b",
}


def get_arch(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.ARCH


def list_archs() -> list[str]:
    return list(_MODULES)
