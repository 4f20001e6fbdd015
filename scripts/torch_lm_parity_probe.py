"""Probe the LM card-vs-CPU check of ``chip_smoke.py``'s lm phase, (a), on
one NVIDIA GPU: where each device's prefill lies against an f64 one.

    python3 scripts/torch_lm_parity_probe.py qwen3-14b --seeds 0,1,2,3
    ATEN_CPU_CAPABILITY=avx2 python3 scripts/torch_lm_parity_probe.py \\
        qwen3-14b --threads 1

For each seed: one pattern group of the arch at full width in f32 (the
weights drawn on the card from ``torch.Generator(...).manual_seed(seed)``,
as (a) draws them), a prefill of B 1 x ``--len`` tokens of
``lm_token_stream``, held by ``chip_smoke.prefill_vs_f64`` on the card
and on the CPU, each twice, against an f64 prefill.  Prints the card's
name and power limit, the CPU settings (ATen's capability, threads, the
environment variables that pick MKL's or ATen's code paths), then one
JSON line a seed.  The CPU's settings come from the environment and
``--threads`` (``torch.set_num_threads``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def probe(name: str, seed: int, S: int, dev) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.data.pipelines import lm_token_stream
    from repro_torch.models import transformer as tf
    full = get_arch(name).full_config
    one = dataclasses.replace(full, n_layers=len(full.pattern),
                              dtype="float32")
    t0 = time.perf_counter()
    params = tf.init_params(
        one, torch.Generator(device=dev).manual_seed(seed), dev)
    toks = torch.from_numpy(
        next(lm_token_stream(1, S, one.vocab, seed))["tokens"])
    out = cs.prefill_vs_f64(params, cs._params_to(params, "cpu"), toks, one)
    return dict(arch=name, seed=seed, S=S, **out,
                seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", nargs="?", default="qwen3-14b")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--len", type=int, default=512)
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_lm_parity_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.core.config import resolve_device
    dev = resolve_device("cuda")
    if args.threads:
        torch.set_num_threads(args.threads)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps(dict(
        torch=torch.__version__, cpu=torch.backends.cpu.get_cpu_capability(),
        threads=torch.get_num_threads(),
        env={k: v for k, v in os.environ.items()
             if k.startswith(("OMP_", "MKL_", "ATEN_", "ONEDNN_"))})))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(probe(args.arch, seed, args.len, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
