"""Probe qwen2-1.5b's ``train_4k`` microbatch on one NVIDIA GPU.

    python3 scripts/torch_train_probe.py [probe ...]

Prints the card's name and power limit, then one JSON line with the
probes named (both by default):

* ``memory``: the FULL config in bf16 (weights drawn from seed 0), beside
  it the state a ``train_4k`` step holds through its accumulation (an
  f32 gradient sum and AdamW's f32 m and v), then one microbatch's
  ``loss_and_grads`` of 1, 2 and 4 sequences of 4,096 tokens (the
  cell's stream): peak GiB (``torch.cuda.max_memory_allocated``) or "out
  of memory", and seconds a microbatch (the second call, synchronised);
* ``profile``: one microbatch of 1 sequence under torch.profiler: wall
  ms, the device's busy ms (CUDA kernel time) and share, device ms by
  ATen operator (self time, forward and backward together), the top
  kernels by device time.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH = "qwen2-1.5b"
SEQ = 4096


def _setup():
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.config import resolve_device
    from repro_torch.data.pipelines import lm_token_stream
    from repro_torch.launch.train import train_loss
    from repro_torch.models import transformer as tf
    dev = resolve_device("cuda")
    cfg = get_arch(ARCH).full_config
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(lm_token_stream(4, SEQ, cfg.vocab)).items()}
    return dev, cfg, params, batch, train_loss("lm", cfg)


def probe_memory() -> dict:
    import torch
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.training.steps import loss_and_grads
    from repro_torch.tree import tree_leaves
    dev, cfg, params, batch, loss_fn = _setup()
    opt = adamw_init(params)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
           for p in tree_leaves(params)]
    out = {"resident_gib": torch.cuda.memory_allocated() / 2**30}
    for micro in (1, 2, 4):
        mb = {k: v[:micro] for k, v in batch.items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            loss_and_grads(loss_fn, params, mb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _, g = loss_and_grads(loss_fn, params, mb)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            del g
            out[f"micro_{micro}"] = dict(
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                seconds=secs, loss=float(loss))
        except torch.cuda.OutOfMemoryError as e:
            out[f"micro_{micro}"] = dict(
                peak_gib="out of memory",
                error=str(e).splitlines()[0][:200])
    del params, opt, acc
    return out


def probe_profile() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.steps import loss_and_grads
    dev, cfg, params, batch, loss_fn = _setup()
    mb = {k: v[:1] for k, v in batch.items()}
    loss_and_grads(loss_fn, params, mb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss_and_grads(loss_fn, params, mb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    busy = sum(kernels.values()) / 1e3
    ops = {}
    for a in prof.key_averages():
        us = getattr(a, "self_device_time_total",
                     getattr(a, "self_cuda_time_total", 0.0))
        if us > 0:
            ops[a.key] = us / 1e3
    top_ops = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:16])
    top_kernels = {k[:80]: v / 1e3 for k, v in sorted(
        kernels.items(), key=lambda kv: -kv[1])[:10]}
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                busy_share=busy / (wall * 1e3), ops_ms=top_ops,
                kernels_ms=top_kernels)


PROBES = {"memory": probe_memory, "profile": probe_profile}


def main(argv=None) -> int:
    import torch
    names = (argv if argv is not None else sys.argv[1:]) or list(PROBES)
    if not torch.cuda.is_available():
        print("torch_train_probe: no CUDA device", file=sys.stderr)
        return 2
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip())
    res = {}
    for n in names:
        res[n] = PROBES[n]()
        torch.cuda.empty_cache()
        print(f"[probe] {n}: {json.dumps(res[n])}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
