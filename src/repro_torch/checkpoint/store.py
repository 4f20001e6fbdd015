"""Atomic directory commits (PyTorch port of the two helpers of
``checkpoint/store.py`` that the storage layout shares).

The rest of that module checkpoints training pytrees and is not ported
yet; these two are all ``storage/layout.py`` needs, and keeping them here
keeps the layout free of JAX.
"""
from __future__ import annotations

import os
import shutil


def fsync_dir(path: str) -> None:
    """fsync a directory so renames/creations inside it are durable."""
    dfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def commit_dir(tmp: str, final: str) -> str:
    """Atomically publish ``tmp`` as ``final``: fsync the staged directory,
    replace any previous ``final``, rename, fsync the parent.  A crash at
    any point leaves either the old complete directory or the new one --
    never a torn mix."""
    fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    fsync_dir(os.path.dirname(os.path.abspath(final)))
    return final
