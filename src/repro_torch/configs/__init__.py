"""Architecture registry of the port: ``get_arch(name)`` /
``list_archs()`` over the archs ported so far -- the recsys family and the
paper's own billion-point deployment config (``freshdiskann-1b``).  The
reference's other archs raise ``KeyError`` naming the ``ROADMAP.md`` item
that ports them.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "fm": "fm",
    "xdeepfm": "xdeepfm",
    "sasrec": "sasrec",
    "deepfm": "deepfm",
    "freshdiskann-1b": "freshdiskann_1b",
}

_LM = "ROADMAP.md Queue 1 item 5 (LM serving)"
_UNPORTED = {
    "qwen3-14b": _LM,
    "qwen2-1.5b": _LM,
    "gemma3-12b": _LM,
    "mixtral-8x7b": _LM,
    "qwen3-moe-30b-a3b": _LM,
    "graphsage-reddit": "ROADMAP.md Queue 1 item 6 (GraphSAGE)",
}


def get_arch(name: str):
    if name in _UNPORTED:
        raise KeyError(f"arch {name!r} is not ported yet: "
                       f"{_UNPORTED[name]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.ARCH


def list_archs() -> list[str]:
    return list(_MODULES)
