"""Probe the LMs' plain-PyTorch paths on one NVIDIA GPU.

    python3 scripts/torch_lm_probe.py [probe ...]

Prints the card's name and power limit, then one JSON line with the
probes named (all of them by default):

* ``gemm``: the rounding error of an f32 product against an f64 one (rms
  relative error and max absolute error, outputs of unit scale), on the
  CPU (``torch.matmul`` in f32), on the card (cuBLAS in f32, TF32 off) and
  through the port's ``layers.matmul`` on the card (f64, rounded once), at
  gemma3-12b's w_down (M 2,048), qwen3-14b's w_down (M 512) and
  qwen3-14b's head (M 1);
* ``decode``: one bf16 ``decode_step`` of qwen3-14b at full width and 8
  of its 40 layers (B 1, a 4,096-slot cache): wall ms a step (host clock
  around synchronised steps) and the device's busy ms a step
  (torch.profiler's CUDA kernel time), so the host's share;
  ``moe_decode`` the same for qwen3-moe-30b-a3b at 8 of its 48 layers and
  B 4 (decode_32k's batch);
* ``moe``: one qwen3-moe-30b-a3b MoE FFN layer (``models/moe.py``) in
  bf16 at prefill_32k's B 1 x S 32,768, ms by part (CUDA events, median
  of 5): router and top-K (``route``), dispatch (``dispatch``: sort,
  positions, the buffer's index), expert products (``expert_ffn``: the
  gather into the padded buffer and three batched GEMMs), combine
  (``combine``), and the whole ``moe_ffn``; against the FLOP bound of the
  products over the rows computed (the padded buffer) and over the
  assignments alone, at 989 TFLOP/s; the assignments capacity dropped;
* ``attention``: ``chunked_attention`` of one qwen3-14b layer in bf16 at
  B 1 x S 32,768 (CUDA events) against its FLOP bound (QK^T and PV over
  the causal pairs at 989 TFLOP/s);
* ``scores``: the two forms of an f32 product of bf16 operands, ms a call
  (CUDA events, mean of 20): ``torch.bmm(..., out_dtype=float32)``, which
  ``layers.mm_f32`` uses on the card, and the operands upcast to f32
  first, on one kv block of that prefill (all 32,768 query rows x 256
  keys) and on one kv head of a decode_32k step (B 8 x 32,768 slots);
* ``lse``: what the logsumexp costs the serving forward, which runs
  ``chunked_attention`` as ``_FlashAttention`` (forming it for a
  backward): gemma3-12b's local and global attention in bf16 at
  prefill_32k's B 2 x S 32,768 under ``inference_mode``, against the same
  forward without it, ms a call (CUDA events, the mean of 3 calls),
  medians and quartiles of 15 alternating pairs, and the device's busy
  ms a call (torch.profiler's CUDA kernel time over 3 calls of each),
  the host's ms to issue a call (no synchronisation inside it) and the
  caching allocator's device allocations, frees and retries over 3
  calls.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _err(got, truth) -> dict:
    e = got.double().cpu() - truth
    return dict(rms_rel=float(e.pow(2).mean().sqrt() / truth.pow(2).mean()
                              .sqrt()), max_abs=float(e.abs().max()))


def gemm_errors(dev) -> list:
    import torch
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(0)
    out = []
    for M, K, N in ((2048, 15360, 3840), (512, 17408, 5120),
                    (1, 5120, 151936)):
        a = torch.randn(M, K, generator=g)
        b = torch.randn(K, N, generator=g) * K ** -0.5
        truth = a.double() @ b.double()
        ad, bd = a.to(dev), b.to(dev)
        out.append(dict(shape=[M, K, N], cpu_f32=_err(a @ b, truth),
                        card_f32=_err(ad @ bd, truth),
                        card_matmul=_err(L.matmul(ad, bd), truth)))
    return out


def decode_share(dev, name: str, batch: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_arch(name).full_config, n_layers=8)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    caches = tf.init_cache(cfg, batch, 4096, dev)
    tok = torch.arange(1, batch + 1, dtype=torch.int32, device=dev)
    for t in range(3):
        _, caches = tf.decode_step(params, caches, tok, t, cfg)
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for t in range(n):
        _, caches = tf.decode_step(params, caches, tok, 3 + t, cfg)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(n):
            _, caches = tf.decode_step(params, caches, tok, 20 + t, cfg)
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    busy = busy / n / 1e3
    return dict(arch=name, layers=cfg.n_layers, batch=batch, wall_ms=wall,
                device_busy_ms=busy, host_share=1 - busy / wall)


def moe_parts(dev) -> dict:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    full = get_arch("qwen3-moe-30b-a3b").full_config
    S = 32768
    cfg = full.moe_cfg(S)
    E, K, D, Fd = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
    n_s = cfg.n_groups
    C = moe.capacity(cfg, S // n_s)
    g = torch.Generator(device=dev).manual_seed(3)
    params = {name: (torch.randn(shape, generator=g, device=dev) * std).to(dt)
              for name, (shape, dt, std) in moe.moe_layout(
                  cfg, torch.bfloat16).items()}
    # an rms_norm output: unit scale
    x = torch.randn(1, S, D, generator=g, device=dev).bfloat16()
    names = ("route", "dispatch", "expert_ffn", "combine")

    def parts():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        top_e, top_w, _, _ = moe.route(params, x, cfg, n_s)
        ev[1].record()
        dst, order, slots = moe.dispatch(top_e.reshape(n_s, -1), cfg, C)
        ev[2].record()
        yb = moe.expert_ffn(params, x.reshape(S, D), slots, E)
        ev[3].record()
        _, kept = moe.combine(yb, dst, order, top_w, K)
        ev[4].record()
        return ev, kept

    runs = []
    for i in range(7):
        ev, kept = parts()
        torch.cuda.synchronize()
        if i >= 2:
            runs.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    ms = {n: statistics.median(r[j] for r in runs)
          for j, n in enumerate(names)}
    ms["moe_ffn"] = _ms(lambda: moe.moe_ffn(params, x, cfg), runs=5)
    rows = E * n_s * C
    per_row = 2 * 3 * D * Fd
    return dict(batch=1, seq=S, groups=n_s, capacity=C,
                assignments=S * K, rows=rows, dropped=int((~kept).sum()),
                ms=ms, flop_bound_ms=rows * per_row / 989e12 * 1e3,
                active_flop_bound_ms=S * K * per_row / 989e12 * 1e3)


def attention_time(dev) -> dict:
    import torch
    from repro_torch.models import layers as L
    g = torch.Generator(device=dev).manual_seed(1)
    S, H, KV, dh = 32768, 40, 8, 128
    q = torch.randn(1, S, H, dh, generator=g, device=dev).bfloat16()
    k = torch.randn(1, S, KV, dh, generator=g, device=dev).bfloat16()
    v = torch.randn(1, S, KV, dh, generator=g, device=dev).bfloat16()
    L.chunked_attention(q[:, :1024], k[:, :1024], v[:, :1024], q_chunk=256,
                        kv_chunk=256)
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    L.chunked_attention(q, k, v, q_chunk=256, kv_chunk=256)
    b.record()
    torch.cuda.synchronize()
    bound = 4 * H * dh * (S * (S + 1) // 2) / 989e12 * 1e3
    return dict(seq=S, ms=a.elapsed_time(b), flop_bound_ms=bound)


def lse_cost(dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    cfg = get_arch("gemma3-12b").full_config
    B, S, H, KV, dh = 2, 32768, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // KV
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, S, H, dh, generator=g, device=dev).bfloat16()
    k = torch.randn(B, S, KV, dh, generator=g, device=dev).bfloat16()
    v = torch.randn(B, S, KV, dh, generator=g, device=dev).bfloat16()
    out = {}
    for kind, window in (("local", cfg.window), ("global", 0)):
        geo = dict(S=S, G=G, window=window, q_chunk=cfg.q_chunk,
                   kv_chunk=cfg.kv_chunk,
                   p_dtype=getattr(torch, cfg.attn_p_dtype))

        def one_path():
            return L.chunked_attention(
                q, k, v, window=window, q_chunk=cfg.q_chunk,
                kv_chunk=cfg.kv_chunk, p_dtype=cfg.attn_p_dtype)

        def no_lse():
            qh = q.reshape(B, S, KV, G, dh).permute(0, 2, 1, 3, 4).reshape(
                B * KV, S, G, dh)
            kh = k.permute(0, 2, 1, 3).reshape(B * KV, S, dh)
            vh = v.permute(0, 2, 1, 3).reshape(B * KV, S, dh)
            acc, _, l = L._flash_fwd(qh, kh, vh, **geo)
            o = acc / torch.clamp(l, min=1e-30)[..., None]
            o = o.reshape(B, KV, S, G, dh).permute(0, 2, 1, 3, 4)
            return o.reshape(B, S, H, dh).to(q.dtype)

        with torch.inference_mode():
            same = torch.equal(one_path(), no_lse())
            times = {"one_path": [], "no_lse": []}
            for i in range(15):
                pair = (("one_path", one_path), ("no_lse", no_lse))
                for name, fn in (pair if i % 2 == 0 else pair[::-1]):
                    times[name].append(_ms(fn, runs=3))
            busy = {}
            for name, fn in (("one_path", one_path), ("no_lse", no_lse)):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                busy[f"{name}_device_busy_ms"] = sum(
                    e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                ) / 3 / 1e3
                torch.cuda.synchronize()
                stats0 = torch.cuda.memory_stats()
                t0 = time.perf_counter()
                for _ in range(3):
                    fn()
                busy[f"{name}_host_issue_ms"] = (
                    time.perf_counter() - t0) / 3 * 1e3
                torch.cuda.synchronize()
                stats1 = torch.cuda.memory_stats()
                for key in ("num_device_alloc", "num_device_free",
                            "num_alloc_retries", "num_sync_all_streams"):
                    busy[f"{name}_{key}"] = (stats1.get(key, 0)
                                             - stats0.get(key, 0))
        out[kind] = dict(
            window=window, equal_outputs=same, **busy,
            one_path_slower_pairs=sum(a > b for a, b in zip(
                times["one_path"], times["no_lse"])),
            **{f"{n}_ms_quartiles": statistics.quantiles(t, n=4)
               for n, t in times.items()},
            ms=times)
    return out


def _ms(fn, runs: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / runs


def score_forms(dev) -> list:
    import torch
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(8, 32768 * 5, 128, generator=g, device=dev).bfloat16()
    k = torch.randn(8, 256, 128, generator=g, device=dev).bfloat16()
    cache = torch.randn(8, 32768, 8, 128, generator=g,
                        device=dev).bfloat16()
    qd = torch.randn(8, 5, 128, generator=g, device=dev).bfloat16()
    out = []
    for what, a, b in (("prefill kv block", q, k.transpose(1, 2)),
                       ("decode kv head", qd, cache[:, :, 0].transpose(1, 2))):
        out.append(dict(
            what=what, a=list(a.shape), b=list(b.shape),
            out_dtype_ms=_ms(lambda: torch.bmm(a, b,
                                               out_dtype=torch.float32)),
            upcast_ms=_ms(lambda: torch.bmm(a.float(), b.float()))))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_lm_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.core.config import resolve_device
    dev = resolve_device("cuda")
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(ident)
    probes = dict(
        gemm=gemm_errors, decode=lambda d: decode_share(d, "qwen3-14b", 1),
        moe_decode=lambda d: decode_share(d, "qwen3-moe-30b-a3b", 4),
        moe=moe_parts, attention=attention_time, scores=score_forms,
        lse=lse_cost)
    names = sys.argv[1:] or list(probes)
    unknown = [n for n in names if n not in probes]
    if unknown:
        print(f"torch_lm_probe: unknown probes {unknown}; choose from "
              f"{list(probes)}", file=sys.stderr)
        return 2
    print(json.dumps({n: probes[n](dev) for n in names}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
