"""End-to-end LM training on the PyTorch port: a ~100M-parameter
qwen-family model trained for a few hundred steps on the synthetic token
stream, with checkpoints and crash-safe resume.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 \\
        [--ckpt-dir DIR] [--device cpu]

(On the CPU add ``--small`` for a fast demonstration run.)  It runs on the
card unless ``--device cpu`` asks for the CPU.  Run it again with the
same ``--ckpt-dir`` and more ``--steps`` and it resumes from the newest
checkpoint; without ``--ckpt-dir`` the checkpoints go to a temporary
directory removed at the end.
"""
import argparse
import tempfile

import torch

from repro_torch.core.config import resolve_device
from repro_torch.data.pipelines import lm_token_stream
from repro_torch.models.transformer import TransformerConfig, init_params
from repro_torch.optim.adamw import adamw_init
from repro_torch.training.loop import run_training
from repro_torch.training.steps import make_lm_train_step
from repro_torch.tree import tree_leaves


def config(small: bool) -> TransformerConfig:
    if small:
        return TransformerConfig(
            name="lm-demo-small", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2, d_head=32, d_ff=256, vocab=2048, qk_norm=True,
            pattern=("g",), q_chunk=64, kv_chunk=64, dtype="float32")
    # ~100M params: 12L x 512 with a 32k vocab
    return TransformerConfig(
        name="lm-demo-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=4, d_head=64, d_ff=2048, vocab=32768, qk_norm=True,
        pattern=("g",), q_chunk=128, kv_chunk=128, dtype="float32")


def train(args, ckpt_dir: str) -> None:
    device = resolve_device(args.device)
    cfg = config(args.small)
    seq = min(args.seq, 64) if args.small else args.seq
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train_lm] {cfg.name}: {n_params / 1e6:.1f}M params on {device}")
    step = make_lm_train_step(cfg, lr=1e-3)
    params, opt, log = run_training(
        device, step, params, adamw_init(params),
        lambda s: lm_token_stream(args.batch, seq, cfg.vocab, start_step=s),
        n_steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=100)
    if len(log) < 2:
        print(f"[train_lm] {len(log)} log line(s) since the checkpoint; "
              f"train more steps to compare losses")
        return
    first, last = log[0]["loss"], log[-1]["loss"]
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        train(args, args.ckpt_dir)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            train(args, tmp)


if __name__ == "__main__":
    main()
