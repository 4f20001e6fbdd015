"""Mixture-of-Experts FFN with group-local capacity dispatch: the PyTorch
port of the JAX package's ``models/moe.py``, forward and gradients.

The reference's function is kept step for step:

* dispatch groups are (batch, seq-chunk) tiles: x [B, S, D] is viewed as
  [B, n_s, Sg, D], and routing, positions and capacity are per group;
* the router runs in f32 (``router_dtype``) even in a bf16 model, a
  softmax over the E experts, the top K by a stable descending sort (the
  lowest expert index first among equal probabilities, as
  ``jax.lax.top_k``), weights renormalised over the K;
* position-within-expert by a stable sort of the group's expert ids and
  a ``searchsorted``: past capacity C = ``capacity(cfg, Sg)`` an
  assignment drops (weight 0), later tokens of a group first;
* the combine gathers each assignment's expert output back through the
  inverse permutation and sums the K weighted outputs in the activation
  dtype.

The expert products take the reference's zero-padded dispatch buffer
(every (group, expert) has C slots), laid out expert-major [E, B*n_s*C,
D]: each product is one batched GEMM over the experts, with no host sync
and no group sizes read on the host.  The price is the padding (a share
of C*E / (Sg*K) - 1 more rows than assignments, 26 % at qwen3-moe's 32k
prefill) and, at a decode step, reading every expert's weights though
the step's tokens select few of them.  A slot no assignment fills holds
an arbitrary token row: its output is never gathered back, so it needs
no zeroing (the reference's zeros give zeros there, also never read).

Under autograd the function is the reference's too:

* the router's gradient flows through the top-K probabilities (the
  values of the stable sort, as ``jax.lax.top_k``'s) and through ``me``
  of the aux loss; the expert counts ``ce`` take none, on either side;
* an empty slot's output is never gathered, so its cotangent is exactly
  zero, and so are its shares of the expert weights' and of x's
  gradients: the reference's zeroed rows give the same sums;
* both gathers (x into the dispatch buffer, the buffer back to the
  assignments) are ``F.embedding`` reads, whose backward on the card
  sums each row's cotangents in a fixed order: a step repeated from one
  state gives the same bits.

The reference's activation-sharding hints stand at its sites
(``distributed.ctx``): ``shard_act`` on the grouped input, the dispatch
buffer, the expert outputs, the picked outputs and the combined output,
each hinted in the reference's [B, n_s, ...] layout (a view of the port's
expert-major buffer where the layouts differ), and ``gathered`` on the
router and the three expert stacks.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..distributed.ctx import gathered, shard_act
from .layers import matmul


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                       # per-expert FFN width
    capacity_factor: float = 1.25
    n_groups: int = 1               # seq-chunks per sequence
    router_dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class Routing:
    """One MoE layer's routing decisions, in token order: ``experts``
    [B, S, K] int64 (probability descending, lowest index first on
    ties), ``kept`` [B, S, K] bool (False where capacity dropped the
    assignment), ``margin`` [B, S] f32: the K-th largest router
    probability less the (K+1)-th (+inf with K == E), how near the
    token's top-K set is to a tie."""
    experts: torch.Tensor
    kept: torch.Tensor
    margin: torch.Tensor


def group_count(n_groups: int, seq_len: int) -> int:
    """Dispatch groups a sequence of ``seq_len`` splits into: ``n_groups``
    at most, lowered until it divides ``seq_len``."""
    g = min(n_groups, seq_len)
    while seq_len % g:
        g -= 1
    return g


def capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    """Slots per (group, expert): int(Sg * K * cf / E) + 1, at least K."""
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts) + 1
    return max(c, cfg.top_k)


def moe_layout(cfg: MoEConfig, dtype: torch.dtype) -> dict:
    """The MoE FFN's parameters: name -> (shape, dtype, init std), the
    reference's ``init_moe_params``: the router [D, E] in f32 whatever
    the model's dtype, the experts in ``dtype``."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    s_in, s_ff = D ** -0.5, Fd ** -0.5
    return {
        "router": ((D, E), torch.float32, s_in),
        "w_gate": ((E, D, Fd), dtype, s_in),
        "w_up": ((E, D, Fd), dtype, s_in),
        "w_down": ((E, Fd, D), dtype, s_ff),
    }


def route(params: dict, x: torch.Tensor, cfg: MoEConfig, n_s: int) -> tuple:
    """Router and top-K of x [B, S, D] in ``n_s`` dispatch groups:
    (top_e [B, n_s, Sg, K] int64, top_w [B, n_s, Sg, K] f32 renormalised
    over the K, aux loss f32 scalar, margin [B, n_s, Sg] f32: the K-th
    largest probability less the (K+1)-th, +inf with K == E)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    x4 = shard_act(x.reshape(B, n_s, S // n_s, D), "batch", "model", None,
                   None)
    router = gathered(params["router"]).to(cfg.router_dtype)
    logits = matmul(x4.to(cfg.router_dtype), router)
    probs = torch.softmax(logits, dim=-1)
    del logits
    ranked_p, ranked_e = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_w, top_e = ranked_p[..., :K], ranked_e[..., :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(dim=(0, 1, 2))                           # [E]
    ce = (torch.bincount(top_e.reshape(-1), minlength=E).double()
          / (B * S * K)).to(torch.float32)
    aux = E * torch.sum(me * ce)
    ranked_p = ranked_p.detach()
    margin = (ranked_p[..., K - 1] - ranked_p[..., K] if K < E
              else torch.full(ranked_p.shape[:-1], float("inf"),
                              device=x.device))
    return top_e, top_w, aux, margin


def dispatch(top_e: torch.Tensor, cfg: MoEConfig, C: int) -> tuple:
    """Group-local positions in expert and the dispatch buffer's index.
    top_e [G, Sg * K] (a group's assignments in token order) -> (dst
    [G, Sg * K]: each assignment's slot in the expert-major buffer [E, M =
    G * C] flattened, E * M where capacity drops it; order [G, Sg * K]:
    the stable sort by expert that ``dst`` follows; slots [E * M + 1]:
    the flat token index (of x [G * Sg, D]) each slot takes)."""
    G, L = top_e.shape
    E, K = cfg.n_experts, cfg.top_k
    M = G * C
    dev = top_e.device
    se, order = torch.sort(top_e, dim=-1, stable=True)
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(L, device=dev) - first
    grp = torch.arange(G, device=dev)[:, None]
    dst = torch.where(pos < C, se * M + grp * C + pos, E * M)
    slots = torch.zeros(E * M + 1, dtype=torch.long, device=dev)
    slots.scatter_(0, dst.reshape(-1),
                   (grp * (L // K) + order // K).reshape(-1))
    return dst, order, slots


def _ref_layout(buf: torch.Tensor, E: int, groups: tuple) -> torch.Tensor:
    """The expert-major buffer [E, B * n_s * C, D] viewed in the
    reference's [B, n_s, E, C, D] layout (no copy), for its hints."""
    B, n_s = groups
    return buf.view(E, B, n_s, -1, buf.shape[-1]).permute(1, 2, 0, 3, 4)


def expert_ffn(params: dict, x: torch.Tensor, slots: torch.Tensor,
               E: int, groups: tuple | None = None) -> torch.Tensor:
    """The experts' SwiGLU over the dispatch buffer: x [T, D] gathered by
    ``slots`` (``dispatch``'s, its trash slot cut) into [E, M, D], one
    batched product a weight, the gate's silu in f32 -> [E * M, D].
    ``groups`` (B, n_s) hints the buffers in the reference's layout."""
    D = x.shape[-1]
    dt = x.dtype
    xb = F.embedding(slots[:-1], x).view(E, -1, D)
    if groups is not None:
        shard_act(_ref_layout(xb, E, groups), "batch", "model", None, None,
                  None)
    w_gate, w_up, w_down = (gathered(params[n]).to(dt)
                            for n in ("w_gate", "w_up", "w_down"))
    g = matmul(xb, w_gate)
    u = matmul(xb, w_up)
    del xb
    h = F.silu(g.float()).to(dt) * u
    del g, u
    yb = matmul(h, w_down)
    if groups is not None:
        shard_act(_ref_layout(yb, E, groups), "batch", "model", None, None,
                  None)
    return yb.view(-1, D)


def combine(yb: torch.Tensor, dst: torch.Tensor, order: torch.Tensor,
            top_w: torch.Tensor, K: int, groups: tuple | None = None
            ) -> tuple:
    """Each assignment's expert output gathered back through the inverse
    permutation of ``order``, weighted and summed over the K in yb's
    dtype: ([G, Sg, D], kept [G, Sg * K] in token order).  ``groups``
    (B, n_s) with B * n_s == G hints the picked and combined outputs in
    the reference's [B, n_s, ...] layout."""
    G, L = dst.shape
    D = yb.shape[-1]
    dt = yb.dtype
    tok_dst = torch.empty_like(dst).scatter_(-1, order, dst)
    kept = tok_dst < yb.shape[0]
    picked = F.embedding(tok_dst.clamp(max=yb.shape[0] - 1),
                         yb)                                 # [G, L, D]
    if groups is not None:
        shard_act(picked.view(*groups, L, D), "batch", "model", None, None)
    w = torch.where(kept, top_w.reshape(G, L), 0.0).to(dt)
    picked = torch.where(kept[..., None], picked, 0).to(dt)
    out = (picked * w[..., None]).view(G, L // K, K, D).sum(dim=2)
    if groups is not None:
        shard_act(out.view(*groups, L // K, D), "batch", "model", None,
                  None)
    return out, kept


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
            routing: list | None = None) -> tuple:
    """x [B, S, D] -> ([B, S, D] in x's dtype, aux loss f32 scalar).

    ``params``: ``router`` [D, E], ``w_gate``/``w_up`` [E, D, F],
    ``w_down`` [E, F, D].  The group count is ``cfg.n_groups`` lowered
    until it divides S.  If ``routing`` is a list, this layer's
    ``Routing`` is appended to it."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    n_s = group_count(cfg.n_groups, S)
    C = capacity(cfg, S // n_s)
    top_e, top_w, aux, margin = route(params, x, cfg, n_s)
    dst, order, slots = dispatch(top_e.reshape(B * n_s, -1), cfg, C)
    yb = expert_ffn(params, x.reshape(B * S, D), slots, E, (B, n_s))
    out, kept = combine(yb, dst, order, top_w, K, (B, n_s))
    if routing is not None:
        routing.append(Routing(experts=top_e.reshape(B, S, K),
                               kept=kept.view(B, S, K),
                               margin=margin.reshape(B, S)))
    return out.reshape(B, S, D), aux
