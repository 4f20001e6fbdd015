"""Transformer building blocks of the decoder LMs: the PyTorch port of the
JAX package's ``models/layers.py``, with the flash attention's
FlashAttention-2 backward (``_FlashAttention``).

Pure functions over tensors; dtypes follow the activations, with f32
(f64 for f64 activations) inside the norms, the SwiGLU gate and the
attention scores and softmax, and f32 RoPE angles, at the reference's
points:

* scores and the PV product are f32 from operands in the activation dtype
  (``preferred_element_type=float32`` in the reference): ``mm_f32``;
* P is cast to V's dtype before the PV product, whatever ``p_dtype``.

``chunked_attention`` computes the reference's flash forward with every
query chunk of a layer batched at once and a loop over kv blocks: block
``j`` updates the running (max, denominator, accumulator) of the query
chunks that visit it in the reference (its band, ``_band_start``) and
skips the chunks for which it lies wholly above the causal diagonal or
outside the window.  Such a block leaves those three unchanged in the
reference (its scores are all ``-inf``: the max keeps its value, the
correction is 1 or the state is still empty, P is 0), so the values are
the reference's and a causal prefill does half the work.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..distributed.ctx import activation_sharding, current_mesh, shard_act

_NEG_INF = float("-inf")
# Bytes of f64 weight columns ``matmul`` holds at once on the CPU: under
# glibc's largest mmap threshold (32 MiB), so the block's memory is reused
# from call to call instead of being mapped and faulted in afresh.
CPU_F64_BLOCK = 16 << 20


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of the f32 steps: f32, f64 for f64 operands (so an f64
    model is f64 throughout, as the gradient checks want)."""
    return torch.promote_types(x.dtype, torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(_acc_dtype(x))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope_freq(half: int, theta: float, device) -> torch.Tensor:
    """RoPE's ``half`` f32 frequencies theta ** (-i / half) on ``device``.
    The exponent in f32, as the reference forms it, then the power in f64
    on the host, rounded once to f32: the correctly rounded f32 power,
    which is what XLA gives.  A last-bit change of a frequency moves the
    angle at position 524,287 by ~0.03 rad, so the bits must be the
    reference's, on the CPU and on the card alike."""
    e = -torch.arange(0, half, dtype=torch.float32) / half
    return (float(theta) ** e.double()).float().to(device)


def rope_tables(positions: torch.Tensor, dh: int, theta: float,
                device) -> tuple:
    """(cos, sin) [..., S, 1, dh // 2] of RoPE's f32 angles for positions
    broadcastable [..., S] (shared by every layer of a forward or a
    decode step)."""
    freq = rope_freq(dh // 2, theta, device)
    ang = positions.to(device, torch.float32)[..., None] * freq
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope_apply(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, dh] rotated by ``rope_tables``' angles: the two halves
    rotated in f32 and concatenated, cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, dh]; positions: broadcastable
    [..., S].  Angles in f32 (positions cast to f32), the two halves
    rotated and concatenated."""
    return rope_apply(x, *rope_tables(positions, x.shape[-1], theta,
                                      x.device))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x @ w_gate) * (x @ w_up) @ w_down, the gate's
    silu in f32, then cast back."""
    dtype = x.dtype
    g = matmul(x, w_gate.to(dtype))
    u = matmul(x, w_up.to(dtype))
    h = F.silu(g.to(_acc_dtype(g))).to(dtype) * u
    del g, u
    return matmul(h, w_down.to(dtype))


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------

def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for the dense layers, in x's dtype.

    f32 is computed in f64 and rounded once to f32, on the card and on the
    CPU alike, so the two agree to well within ``chip_smoke.py``'s
    card-vs-CPU bound at full width, which plain f32 products missed.
    Against an f64 product (``scripts/torch_lm_probe.py``, NVIDIA H100
    80GB HBM3 at 700.00 W, TF32 off), cuBLAS's f32 GEMM at M 2,048 x K
    15,360 x N 3,840 (gemma3's w_down) erred by 2.2e-6 rms relative (max
    2.7e-5), six times the CPU's 3.7e-7, and both devices' M 1 product
    of qwen3-14b's head (K 5,120 x N 151,936) by up to 8.9e-6; the f64
    product by 2.5e-8.  bf16 keeps the plain product (cuBLAS accumulates
    it in f32).

    ``w`` may carry leading batch dims (an expert stack [E, K, N] against
    x [E, M, K]).  On the CPU the f64 copy of ``w`` is made
    ``CPU_F64_BLOCK`` bytes of columns at a time: a whole one (8 GB for
    gemma3's head, 3.7 GB for a mixtral expert stack) would be allocated,
    page by page, on every call.  Under autograd the blocks' gradients
    are joined once (``split``'s backward)."""
    if x.dtype != torch.float32:
        return x @ w
    xd = x.double()
    if x.is_cuda:
        return (xd @ w.double()).float()
    cols = max(1, CPU_F64_BLOCK // (8 * w[..., 0].numel()))
    # ``split``, not a slice a block: under autograd a slice's backward
    # writes its block into zeros the size of ``w``, once a block
    return torch.cat([(xd @ wb.double()).float()
                      for wb in w.split(cols, dim=-1)], dim=-1)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` as an f32 product: f32 output, f32 accumulation
    (f64 operands keep an f64 product, for the gradient checks).

    f32 operands take ``torch.bmm`` (TF32 is off on the card; the
    attention's K is a head, a kv block or a cache of probabilities
    summing to 1, and its f32 sums kept the checks in bound).  bf16 or
    f16 operands on the card take ``torch.bmm(..., out_dtype=float32)``
    (cuBLAS, f32 accumulate and output), and on the CPU the operands are
    upcast first: the product of two bf16 values is exact in f32, so both
    are the reference's ``preferred_element_type=float32`` product.  A
    plain bf16 ``bmm`` would round each score to bf16 (8 bits lost)."""
    if a.dtype == b.dtype and a.dtype in (torch.float32, torch.float64):
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


# ---------------------------------------------------------------------------
# Chunked (flash) attention
# ---------------------------------------------------------------------------

def _band_geometry(S: int, window: int, q_chunk: int, kv_chunk: int):
    if window and window < S:
        # the band must cover [q_start - window + 1, q_start + q_chunk):
        # width q_chunk + window - 1, plus kv_chunk alignment slack
        band_blocks = min((window + q_chunk) // kv_chunk + 2, S // kv_chunk)
    else:
        band_blocks = S // kv_chunk
    return band_blocks, band_blocks * kv_chunk


def _band_start(qi: int, S: int, band: int, q_chunk: int,
                kv_chunk: int) -> int:
    band_end = (qi + 1) * q_chunk
    start = max(band_end - band, 0)
    start = (start // kv_chunk) * kv_chunk
    return min(start, S - band)


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int) -> torch.Tensor:
    mask = k_pos[None, :] <= q_pos[:, None]                  # causal
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


@functools.lru_cache(maxsize=64)
def block_plan(S: int, window: int, q_chunk: int, kv_chunk: int) -> tuple:
    """The reference's visits, kv block by kv block: ``(j, qa, qb)`` runs
    of query chunks ``qa <= qi < qb`` whose band holds kv block ``j`` and
    for which the block is not wholly masked (above the causal diagonal
    or before the window), in ascending ``j``."""
    n_q, n_kv = S // q_chunk, S // kv_chunk
    _, band = _band_geometry(S, window, q_chunk, kv_chunk)
    starts = [_band_start(qi, S, band, q_chunk, kv_chunk)
              for qi in range(n_q)]
    plan = []
    for j in range(n_kv):
        k0, k1 = j * kv_chunk, (j + 1) * kv_chunk - 1    # first, last key
        run = None
        for qi in range(n_q):
            q0, q1 = qi * q_chunk, (qi + 1) * q_chunk - 1
            visit = (starts[qi] <= k0 < starts[qi] + band and k0 <= q1
                     and not (window and k1 <= q0 - window))
            if visit and run is None:
                run = qi
            elif not visit and run is not None:
                plan.append((j, run, qi))
                run = None
        if run is not None:
            plan.append((j, run, n_q))
    return tuple(plan)


def _mask_rows(s4: torch.Tensor, r0: int, k0: int, kv_chunk: int,
               window: int) -> None:
    """-inf where the causal / window mask is False, in place, on the rows
    that hold a False.  s4: [B*KV, rows, G, kv_chunk] scores of query rows
    ``r0..`` against keys ``k0..``."""
    rows = s4.shape[1]
    spans = [(0, min(rows, k0 + kv_chunk - 1 - r0))]     # the diagonal
    if window:                                           # the window edge
        spans.append((max(0, k0 + window - r0), rows))
    dev = s4.device
    k_pos = torch.arange(k0, k0 + kv_chunk, device=dev)
    for lo, hi in spans:
        if lo >= hi:
            continue
        q_pos = torch.arange(r0 + lo, r0 + hi, device=dev)
        ok = _block_mask(q_pos, k_pos, window)
        s4[:, lo:hi].masked_fill_(~ok[None, :, None, :], _NEG_INF)


def _flash_fwd(qh, kh, vh, *, S: int, G: int, window: int, q_chunk: int,
               kv_chunk: int, p_dtype):
    """The forward on [B*KV, S, G, dh] queries and [B*KV, S, dh] keys and
    values: (acc [B*KV, S*G, dh] f32 unnormalised, m, l [B*KV, S*G])."""
    BK, dh = qh.shape[0], qh.shape[-1]
    scale = dh ** -0.5
    dev, dt = qh.device, _acc_dtype(qh)
    m = torch.full((BK, S * G), _NEG_INF, dtype=dt, device=dev)
    l = torch.zeros((BK, S * G), dtype=dt, device=dev)
    acc = torch.zeros((BK, S * G, dh), dtype=dt, device=dev)

    for j, qa, qb in block_plan(S, window, q_chunk, kv_chunk):
        r0, r1 = qa * q_chunk, qb * q_chunk
        k0 = j * kv_chunk
        rows = slice(r0 * G, r1 * G)
        kj = kh[:, k0:k0 + kv_chunk]
        vj = vh[:, k0:k0 + kv_chunk]
        s = mm_f32(qh[:, r0:r1].reshape(BK, (r1 - r0) * G, dh),
                   kj.transpose(1, 2))
        s.mul_(scale)
        _mask_rows(s.view(BK, r1 - r0, G, kv_chunk), r0, k0, kv_chunk,
                   window)
        m_old = m[:, rows]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        # guard fully-masked rows: exp(-inf - -inf) would be NaN.  With a
        # finite m_safe, exp(-inf - m_safe) is exactly 0: the reference's
        # where(isfinite(s), ..., 0) on masked scores.
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros((), device=dev))
        s.sub_(m_safe[..., None]).exp_()
        p = s.to(p_dtype)
        corr = torch.where(torch.isfinite(m_old), torch.exp(m_old - m_safe),
                           torch.zeros((), device=dev))
        l[:, rows] = l[:, rows] * corr + p.to(dt).sum(dim=-1)
        pv = mm_f32(p.to(vj.dtype), vj)
        del s, p
        acc[:, rows] = acc[:, rows] * corr[..., None] + pv
        m[:, rows] = m_new
    return acc, m, l


def _flash_bwd(qh, kh, vh, out, lse, dout, *, S: int, G: int, window: int,
               q_chunk: int, kv_chunk: int, p_dtype, B: int):
    """FlashAttention-2 backward from the saved logsumexp, over the
    forward's visits (``block_plan``): each visited block recomputes its
    probabilities and adds to dq, dk and dv (f32; f64 for f64 operands).  The reference runs
    the same recurrences in two passes (dq by query chunk, dk/dv by kv
    block); their sums over blocks are the same terms in another order.
    ``B`` is the batch size, for the reference's hints (``_bwd_hints``),
    emitted under the forward's activation-sharding context."""
    BK, dh = qh.shape[0], qh.shape[-1]
    scale = dh ** -0.5
    dev, dt = qh.device, _acc_dtype(qh)
    q2 = qh.reshape(BK, S * G, dh)
    do = dout.to(dt)
    delta = (do * out).sum(dim=-1)                          # [BK, S*G]
    lse_safe = torch.where(torch.isfinite(lse), lse,
                           torch.zeros((), device=dev))
    _bwd_hints(B, qh, kh, vh, do, delta, lse_safe, S // q_chunk,
               S // kv_chunk)
    do_p = do.to(p_dtype)
    dq = torch.zeros((BK, S * G, dh), dtype=dt, device=dev)
    dk = torch.zeros((BK, S, dh), dtype=dt, device=dev)
    dv = torch.zeros((BK, S, dh), dtype=dt, device=dev)
    for j, qa, qb in block_plan(S, window, q_chunk, kv_chunk):
        r0, r1 = qa * q_chunk, qb * q_chunk
        k0 = j * kv_chunk
        rows = slice(r0 * G, r1 * G)
        kj = kh[:, k0:k0 + kv_chunk]
        vj = vh[:, k0:k0 + kv_chunk]
        qr = q2[:, rows]
        s = mm_f32(qr, kj.transpose(1, 2))
        s.mul_(scale)
        _mask_rows(s.view(BK, r1 - r0, G, kv_chunk), r0, k0, kv_chunk,
                   window)
        p = torch.exp(s - lse_safe[:, rows, None])
        del s
        dv[:, k0:k0 + kv_chunk] += mm_f32(p.to(p_dtype).transpose(1, 2),
                                          do_p[:, rows])
        dp = mm_f32(do_p[:, rows], vj.to(p_dtype).transpose(1, 2))
        ds = (p * (dp - delta[:, rows, None]) * scale).to(p_dtype)
        del p, dp
        dq[:, rows] += mm_f32(ds, kj.to(p_dtype))
        dk[:, k0:k0 + kv_chunk] += mm_f32(ds.transpose(1, 2),
                                          qr.to(p_dtype))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``chunked_attention`` with the FlashAttention-2 backward: saves q,
    k, v, the output and the logsumexp, no score block.  Where no
    gradient is wanted (``inference_mode``, ``no_grad``, inputs that need
    none) ``apply`` records nothing and the saved tensors go with it.
    The forward's activation-sharding mesh is kept with them: on the card
    the backward runs in autograd's device thread, which does not see the
    context, and it emits its hints against the same mesh."""

    @staticmethod
    def forward(ctx, qh, kh, vh, geo: dict, B: int):
        acc, m, l = _flash_fwd(qh, kh, vh, **geo)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                          torch.full((), _NEG_INF, device=l.device))
        ctx.geo = geo
        ctx.B = B
        ctx.mesh = current_mesh()
        ctx.save_for_backward(qh, kh, vh, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qh, kh, vh, out, lse = ctx.saved_tensors
        with activation_sharding(ctx.mesh):
            dq, dk, dv = _flash_bwd(qh, kh, vh, out, lse, dout, B=ctx.B,
                                    **ctx.geo)
        return (dq.reshape(qh.shape).to(qh.dtype), dk.to(kh.dtype),
                dv.to(vh.dtype), None, None)


def _heads_first(t: torch.Tensor, B: int) -> torch.Tensor:
    """A [B*KV, S, ...] tensor of the port's layout viewed as the
    reference's [B, S, KV, ...] (no copy)."""
    t = t.view(B, t.shape[0] // B, *t.shape[1:])
    return t.transpose(1, 2)


def _bwd_hints(B: int, qh, kh, vh, do, delta, lse, n_q: int,
               n_kv: int) -> None:
    """The reference backward's hints, in its order, on views of the
    port's tensors in the reference's layouts: the query chunks and their
    cotangent, k and v, the flat q, dout, delta and lse, and the kv
    blocks."""
    q5 = _heads_first(qh, B)                             # [B, S, KV, G, dh]
    do5 = _heads_first(do.reshape(qh.shape), B)
    k4, v4 = _heads_first(kh, B), _heads_first(vh, B)   # [B, S, KV, dh]
    tail = (None,) * 4
    shard_act(q5.unflatten(1, (n_q, -1)), "batch", "model", *tail)
    shard_act(do5.unflatten(1, (n_q, -1)), "batch", "model", *tail)
    shard_act(k4, "batch", None, None, None)
    shard_act(v4, "batch", None, None, None)
    shard_act(q5, "batch", None, None, None, None)
    shard_act(do5, "batch", None, None, None, None)
    for t in (delta, lse):                               # [B, S, KV, G]
        shard_act(_heads_first(t.view(qh.shape[:-1]), B), "batch", None,
                  None, None)
    shard_act(k4.unflatten(1, (n_kv, -1)), "batch", "model", None, None,
              None)
    shard_act(v4.unflatten(1, (n_kv, -1)), "batch", "model", None, None,
              None)


def chunked_attention(
    q: torch.Tensor,        # [B, S, H, dh]  (RoPE already applied)
    k: torch.Tensor,        # [B, S, KV, dh]
    v: torch.Tensor,        # [B, S, KV, dh]
    *,
    window: int = 0,        # 0 = full causal; >0 = sliding window
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    p_dtype="float32",      # dtype the probability blocks are held in
) -> torch.Tensor:
    """Flash attention: the [S, S] score matrix is never formed.  Every
    query chunk at once, a loop over kv blocks with a running (max,
    denominator) per query row (see the module docstring).  It runs as
    ``_FlashAttention``, whose backward recomputes each block from the
    saved logsumexp.  Returns [B, S, H, dh] in q's dtype."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV                                   # GQA group size
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, S)
    assert S % q_chunk == 0 and S % kv_chunk == 0
    if isinstance(p_dtype, str):
        p_dtype = getattr(torch, p_dtype)
    BK = B * KV
    # [B, S, KV, G, dh] -> [B*KV, S, G, dh]: a run of query rows is one
    # contiguous [rows * G, dh] matrix per (batch, kv head)
    qh = q.reshape(B, S, KV, G, dh).permute(0, 2, 1, 3, 4).reshape(
        BK, S, G, dh)
    kh = k.permute(0, 2, 1, 3).reshape(BK, S, dh)
    vh = v.permute(0, 2, 1, 3).reshape(BK, S, dh)
    geo = dict(S=S, G=G, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
               p_dtype=p_dtype)
    shard_act(qh.view(B, KV, S // q_chunk, q_chunk, G, dh).permute(
        0, 2, 3, 1, 4, 5), "batch", "model", None, None, None, None)
    shard_act(k, "batch", None, None, None)
    shard_act(v, "batch", None, None, None)
    out = _FlashAttention.apply(qh, kh, vh, geo, B)
    out = out.reshape(B, KV, S, G, dh).permute(0, 2, 1, 3, 4)
    return out.reshape(B, S, H, dh).to(q.dtype)


def decode_attention(
    q: torch.Tensor,            # [B, 1, H, dh] (RoPE applied)
    k_cache: torch.Tensor,      # [B, W, KV, dh] (RoPE applied at write)
    v_cache: torch.Tensor,      # [B, W, KV, dh]
    cache_pos: torch.Tensor,    # [W] absolute position per slot (-1 = empty)
    pos: int,                   # position of the query token
    *,
    window: int = 0,
) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffer) KV cache.

    The f32 products run on strided views of the cache (no copy of it):
    one per sequence with its kv heads as the batch when B <= KV, else one
    per kv head with the sequences as the batch; the softmax runs once
    over all [B, KV, G, W] scores."""
    B, W, KV, dh = k_cache.shape
    H = q.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, dh)
    ok = (cache_pos >= 0) & (cache_pos <= pos)
    if window:
        ok &= cache_pos > pos - window
    by_seq = B <= KV
    if by_seq:
        s = torch.stack([mm_f32(qg[b], k_cache[b].permute(1, 2, 0))
                         for b in range(B)])
    else:
        s = torch.stack([mm_f32(qg[:, h], k_cache[:, :, h].transpose(1, 2))
                         for h in range(KV)], dim=1)      # [B, KV, G, W]
    s.mul_(dh ** -0.5)
    s.masked_fill_(~ok, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    if by_seq:
        out = torch.stack([mm_f32(p[b], v_cache[b].transpose(0, 1))
                           for b in range(B)])
    else:
        out = torch.stack([mm_f32(p[:, h], v_cache[:, :, h])
                           for h in range(KV)], dim=1)    # [B, KV, G, dh]
    return out.reshape(B, 1, H, dh).to(q.dtype)
