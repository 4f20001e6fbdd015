"""Fault-tolerant training loop: the PyTorch port of the JAX package's
``training/loop.py``.

Composes a train step, a deterministic data stream (resume = step
counter), the ``AsyncCheckpointer`` and crash recovery.  Given a ``Mesh``
(``distributed.sharding``), each batch is placed over the mesh's batch
axes (``place_batch``: blocks of ``P(ba)``, as the reference places
them), and the latest checkpoint is restored by ``param_shardings`` and
``opt_shardings`` when both are given (elastic resharding against the
current mesh), else onto the mesh's lead device.  Given a device, the
loop runs there, batches and restore included.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..checkpoint.store import (AsyncCheckpointer, latest_step,
                                restore_checkpoint)
from ..core.config import resolve_device
from ..distributed.sharding import Mesh, place_batch


def _to_device(x, device):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def run_training(
    mesh,                            # a Mesh, or one device
    train_step: Callable,            # (params, opt, batch) -> ...
    params: Any,
    opt_state: Any,
    data_stream_fn: Callable[[int], Iterator[dict]],  # start_step -> iter
    *,
    n_steps: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 100,
    param_shardings: Any = None,
    opt_shardings: Any = None,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
) -> tuple[Any, Any, list]:
    """Returns (params, opt_state, metrics_log).  Batches' numpy arrays
    and tensors are placed over ``mesh``'s batch axes, or go to the one
    device given (the card unless the caller asks for the CPU); other
    values (a per-step seed) pass as they are."""
    if isinstance(mesh, Mesh):
        device = resolve_device(mesh.lead)
        where = f"{mesh.size} grid positions"
    else:
        device, mesh = resolve_device(mesh), None
        where = str(device)
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        shardings = None
        if param_shardings is not None and opt_shardings is not None:
            shardings = {"params": param_shardings, "opt": opt_shardings}
        tree, start = restore_checkpoint(ckpt_dir, device=device,
                                         shardings=shardings)
        params, opt_state = tree["params"], tree["opt"]
        log_fn(f"[loop] restored checkpoint at step {start} onto {where}")

    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    stream = data_stream_fn(start)
    log = []
    t0 = time.perf_counter()
    for step in range(start, n_steps):
        host = next(stream)
        batch = (place_batch(mesh, host) if mesh is not None else
                 {k: _to_device(v, device) for k, v in host.items()})
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if (step + 1) % log_every == 0 or step + 1 == n_steps:
            m = {k: float(v) for k, v in metrics.items()}
            dt = (time.perf_counter() - t0) / log_every
            t0 = time.perf_counter()
            log.append({"step": step + 1, **m, "sec_per_step": dt})
            log_fn(f"[loop] step {step + 1} "
                   + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                   + f" ({dt:.3f}s/step)")
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    if ckpt:
        ckpt.save(n_steps, {"params": params, "opt": opt_state})
        ckpt.wait()
    return params, opt_state, log
