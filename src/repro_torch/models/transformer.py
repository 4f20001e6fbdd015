"""Decoder-only transformer family: the PyTorch port of the JAX package's
``models/transformer.py``: the serving path of the five LM archs (the
dense qwen3-14b, qwen2-1.5b and gemma3-12b, and the MoE mixtral-8x7b and
qwen3-moe-30b-a3b) and ``lm_loss``'s gradients for all five.

The reference's layout is kept:

* **Pattern groups.**  A config declares a per-group layer pattern, e.g.
  ``("l","l","l","l","l","g")`` for gemma3's 5:1 local:global.  Each
  weight of pattern position ``pi`` is stacked ``[n_groups, ...]`` in
  ``params["blocks"][pi]``; the decoder runs all groups of position 0,
  then all of position 1, and so on, as the reference's ``lax.scan`` over
  each position's stack does.  Local layers get ring-buffer KV caches of
  ``window`` slots, global layers full-length ones.
* **Parameters** are a dict of tensors: ``embed`` [V, D], ``lm_head``
  [D, V], ``final_norm`` [D] (f32), ``blocks`` (a list of dicts), with the
  reference's names, shapes and dtypes; ``convert.lm_params`` carries the
  reference's parameters across by name (``blocks.<pi>.<name>``).
* Chunked flash-style attention for the prefill (``layers``), GQA,
  qk-norm, QKV bias, RoPE, RMSNorm, SwiGLU per config.
* **MoE** -- when ``moe_experts > 0`` the FFN is ``moe.moe_ffn``, the
  group-local top-k capacity dispatch, its parameters under
  ``blocks.<pi>.moe.<name>`` (the router f32 in any model); ``forward``
  returns the aux loss summed over layers.  The dispatch group count is
  ``moe_cfg(S)``'s: a decode step is one group of one token, whose K
  distinct experts take a slot each, so decoding never drops an
  assignment, while a prefill may.

The reference's ``jax.checkpoint`` + ``lax.scan`` over groups is a loop
over groups (``_forward``; ``forward`` runs it under
``torch.inference_mode()``, ``lm_loss`` under autograd, each layer under
``torch.utils.checkpoint``: a layer keeps its input for the backward and
recomputes the rest, as ``jax.checkpoint`` does).  The reference's
activation-sharding hints stand at its sites (``distributed.ctx``):
``shard_act`` on the residual stream, the KV caches and the logits, and
``gathered`` on every projection weight, so a layer's ZeRO-3 weights
(``Sharded`` leaves) are put together inside the layer and gathered
again in its recompute, the blocks staying autograd's leaves; a norm,
bias, the embedding and the head are read with ``whole``.  On plain
tensors all three are identities.  ``decode_step`` updates the caches it
is given in place (the reference donates them) and returns them: a cache
handed to a step is consumed by it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.config import resolve_device
from ..distributed.ctx import gathered, shard_act, whole
from .layers import (chunked_attention, decode_attention, matmul, rms_norm,
                     rope_apply, rope_tables, swiglu)
from .moe import MoEConfig, group_count, moe_ffn, moe_layout


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    window: int = 0                       # sliding window for 'l' layers
    pattern: Tuple[str, ...] = ("g",)     # per-group layer kinds: 'l'/'g'
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_groups: int = 16                  # dispatch groups (>= data shards)
    moe_cf: float = 1.25                  # expert capacity factor
    dtype: str = "bfloat16"
    q_chunk: int = 1024
    kv_chunk: int = 1024
    attn_p_dtype: str = "float32"   # flash-attn probability-block dtype

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.pattern) == 0
        return self.n_layers // len(self.pattern)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def moe_cfg(self, seq_len: int) -> MoEConfig:
        """The MoE FFN's config for a sequence of ``seq_len``: ``moe_groups``
        dispatch groups, lowered until they divide ``seq_len``."""
        return MoEConfig(
            n_experts=self.moe_experts, top_k=self.moe_top_k,
            d_model=self.d_model, d_ff=self.moe_d_ff,
            n_groups=group_count(self.moe_groups, seq_len),
            capacity_factor=self.moe_cf)

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        D, H, KV, dh, F = (self.d_model, self.n_heads, self.n_kv_heads,
                           self.d_head, self.d_ff)
        attn = D * H * dh + 2 * D * KV * dh + H * dh * D
        if self.is_moe:
            ffn = self.moe_experts * 3 * D * self.moe_d_ff + D * self.moe_experts
        else:
            ffn = 3 * D * F
        per_layer = attn + ffn + 2 * D
        return self.n_layers * per_layer + 2 * self.vocab * D + D

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of the experts)."""
        if not self.is_moe:
            return self.param_count()
        D = self.d_model
        attn = D * self.n_heads * self.d_head * 2 \
            + 2 * D * self.n_kv_heads * self.d_head
        ffn = self.moe_top_k * 3 * D * self.moe_d_ff + D * self.moe_experts
        per_layer = attn + ffn + 2 * D
        return self.n_layers * per_layer + 2 * self.vocab * D + D


# ---------------------------------------------------------------------------
# Parameters (stacked [n_groups, ...] per pattern position)
# ---------------------------------------------------------------------------

def block_layout(cfg: TransformerConfig) -> dict:
    """One layer's parameters: name -> (shape, dtype, init std or None for
    zeros), in the reference's ``_init_block`` names and dtypes (an MoE
    config's FFN as ``moe.<name>``)."""
    D, H, KV, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.d_head, cfg.d_ff)
    dt, f32 = cfg.act_dtype, torch.float32
    s = D ** -0.5
    p = {
        "ln1": ((D,), f32, None),
        "ln2": ((D,), f32, None),
        "wq": ((D, H, dh), dt, s),
        "wk": ((D, KV, dh), dt, s),
        "wv": ((D, KV, dh), dt, s),
        "wo": ((H, dh, D), dt, (H * dh) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = ((H, dh), dt, None)
        p["bk"] = ((KV, dh), dt, None)
        p["bv"] = ((KV, dh), dt, None)
    if cfg.qk_norm:
        p["qnorm"] = ((dh,), f32, None)
        p["knorm"] = ((dh,), f32, None)
    if cfg.is_moe:
        for name, leaf in moe_layout(cfg.moe_cfg(cfg.moe_groups),
                                     dt).items():
            p[f"moe.{name}"] = leaf
    else:
        p["w_gate"] = ((D, F), dt, s)
        p["w_up"] = ((D, F), dt, s)
        p["w_down"] = ((F, D), dt, F ** -0.5)
    return p


def param_layout(cfg: TransformerConfig) -> dict:
    """Every parameter: dotted name (``embed``, ``blocks.<pi>.<name>``, ...)
    -> (shape, dtype, init std or None), block shapes with their leading
    ``n_groups``."""
    dt = cfg.act_dtype
    out = {
        "embed": ((cfg.vocab, cfg.d_model), dt, cfg.d_model ** -0.5),
        "lm_head": ((cfg.d_model, cfg.vocab), dt, cfg.d_model ** -0.5),
        "final_norm": ((cfg.d_model,), torch.float32, None),
    }
    for pi in range(len(cfg.pattern)):
        for name, (shape, dtype, std) in block_layout(cfg).items():
            out[f"blocks.{pi}.{name}"] = ((cfg.n_groups,) + shape, dtype,
                                          std)
    return out


def set_param(params: dict, name: str, value) -> None:
    """Put ``value`` at dotted ``name`` of a parameter dict
    (``blocks.<pi>.<name>`` or ``blocks.<pi>.moe.<name>``)."""
    parts = name.split(".")
    node = params
    if parts[0] == "blocks":
        blocks = params.setdefault("blocks", [])
        pi = int(parts[1])
        while len(blocks) <= pi:
            blocks.append({})
        node, parts = blocks[pi], parts[2:]
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def get_param(params, name: str):
    """The leaf at dotted ``name`` (``blocks.<pi>.<name>`` indexes the
    list of blocks) of a parameter dict: the port's or the reference's."""
    leaf = params
    for part in name.split("."):
        leaf = leaf[int(part)] if part.isdigit() else leaf[part]
    return leaf


def param_items(params: dict) -> list:
    """(dotted name, leaf) of every leaf of a parameter dict, in the names
    ``set_param`` and ``get_param`` take."""
    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, list):
            items = enumerate(node)
        else:
            return [(prefix, node)]
        return [kv for k, v in items
                for kv in walk(v, f"{prefix}.{k}" if prefix else str(k))]
    return walk(params, "")


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Parameters of ``cfg`` with the reference's init scales (normal
    weights, zero norms and biases), drawn on ``generator`` (a
    ``torch.Generator`` on ``device``) one layer at a time in f32 and cast
    to the parameter's dtype: no f32 copy of a bf16 model is ever held.
    On the card unless ``device`` asks for the CPU.  The draws are
    torch's, not ``jax.random``'s: to hold the port against the reference,
    carry the reference's parameters across with ``convert.lm_params``."""
    device = resolve_device(device)
    params: dict = {}
    for name, (shape, dtype, std) in param_layout(cfg).items():
        t = torch.zeros(shape, dtype=dtype, device=device)
        if std is not None:
            # one layer of a block stack (or a whole table) at a time
            parts = (t.view(shape[0], -1) if name.startswith("blocks")
                     else t[None])
            for part in parts:
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=device).mul_(std))
        set_param(params, name, t)
    return params


# ---------------------------------------------------------------------------
# Forward (prefill / scoring)
# ---------------------------------------------------------------------------

def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``: x [B, S, D] @ w [D, H, dh]."""
    D, H, dh = w.shape
    return matmul(x, w.reshape(D, H * dh).to(x.dtype)).view(
        *x.shape[:-1], H, dh)


def _layer_params(bp: dict, gi: int) -> dict:
    """Layer ``gi``'s weights of a pattern position's stacks (the MoE's
    under ``moe``)."""
    return {n: ({k: v[gi] for k, v in t.items()} if isinstance(t, dict)
                else t[gi]) for n, t in bp.items()}


def _unstack(bp: dict, n_groups: int) -> list:
    """Every layer's weights of a pattern position, one ``unbind`` a
    stack: under autograd a stack's gradient is then put together once,
    not summed from one zero-padded full-size gradient a layer (what
    indexing a stack a layer gives)."""
    parts = {n: ({k: v.unbind(0) for k, v in t.items()}
                 if isinstance(t, dict) else t.unbind(0))
             for n, t in bp.items()}
    return [_layer_params(parts, gi) for gi in range(n_groups)]


def _qkv(lp: dict, x: torch.Tensor, cfg: TransformerConfig, tables: tuple):
    """q, k (RoPE applied with ``tables``, ``layers.rope_tables``) and v
    of the layer whose weights are ``lp``."""
    h = rms_norm(x, whole(lp["ln1"]), cfg.norm_eps)
    q, k, v = (_proj(h, gathered(lp[w])) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = (q + whole(lp["bq"]), k + whole(lp["bk"]),
                   v + whole(lp["bv"]))
    if cfg.qk_norm:
        q = rms_norm(q, whole(lp["qnorm"]), cfg.norm_eps)
        k = rms_norm(k, whole(lp["knorm"]), cfg.norm_eps)
    return rope_apply(q, *tables), rope_apply(k, *tables), v


def _out_proj(x: torch.Tensor, o: torch.Tensor, wo: torch.Tensor):
    """x + ``einsum("bshk,hkd->bsd")``: o [B, S, H, dh] @ wo [H, dh, D]."""
    wo = gathered(wo)
    H, dh, D = wo.shape
    return x + matmul(o.reshape(*o.shape[:-2], H * dh),
                      wo.reshape(H * dh, D).to(o.dtype))


def _ffn(lp: dict, x: torch.Tensor, cfg: TransformerConfig,
         routing: list | None):
    """x + the FFN of the layer whose weights are ``lp``, and its aux loss
    (None for a dense FFN)."""
    h = rms_norm(x, whole(lp["ln2"]), cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe_ffn(lp["moe"], h, cfg.moe_cfg(x.shape[1]), routing)
        return x + y, aux
    return x + swiglu(h, gathered(lp["w_gate"]), gathered(lp["w_up"]),
                      gathered(lp["w_down"])), None


def _layer(lp: dict, x: torch.Tensor, cfg: TransformerConfig,
           tables: tuple, window: int, routing: list | None):
    """The layer whose weights are ``lp``: (x, aux, k, v)."""
    q, k, v = _qkv(lp, x, cfg, tables)
    o = chunked_attention(q, k, v, window=window, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk, p_dtype=cfg.attn_p_dtype)
    del q
    x = _out_proj(x, o, lp["wo"])
    del o
    x = shard_act(x, "batch", "model", None)
    x, aux = _ffn(lp, x, cfg, routing)
    x = shard_act(x, "batch", "model", None)
    return x, aux, k, v


def _head(params: dict, x: torch.Tensor, cfg: TransformerConfig, *,
          prefill: bool = True):
    """Logits of x through the final norm and the head (a prefill's x
    hinted batch-only before the head, as the reference's)."""
    x = rms_norm(x, whole(params["final_norm"]), cfg.norm_eps)
    if prefill:
        x = shard_act(x, "batch", None, None)
    logits = matmul(x, whole(params["lm_head"]).to(x.dtype))
    return shard_act(logits, "batch", None, "model")


def cache_widths(cfg: TransformerConfig, max_len: int) -> list:
    """KV-cache slots per pattern position: a ring of ``window`` for 'l',
    ``max_len`` for 'g'."""
    return [min(cfg.window, max_len) if kind == "l" else max_len
            for kind in cfg.pattern]


@torch.inference_mode()
def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            *, collect_cache: bool = False, last_only: bool = False,
            routing: list | None = None):
    """The prefill / scoring forward under ``torch.inference_mode`` (no
    gradient); ``_forward`` says what it returns."""
    return _forward(params, tokens, cfg, collect_cache=collect_cache,
                    last_only=last_only, routing=routing)


def _forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
             *, collect_cache: bool = False, last_only: bool = False,
             routing: list | None = None):
    """tokens [B, S] -> (logits [B, S, V] (or [B, 1, V] with last_only),
    aux_loss (f32: summed over the MoE layers, 0.0 for a dense model),
    caches|None).

    ``last_only`` computes the head only for the final position (prefill
    serving: no [B, S, V] tensor).  ``routing``, a list, receives each MoE
    layer's ``moe.Routing`` in the order the layers run.

    caches (prefill): per pattern position, stacked over groups:
      k/v [n_groups, B, W_p, KV, dh] filled with the last
      W_p = min(window or S, S) tokens at slots 0..W_p-1, pos [W_p] int32
      absolute positions.
    """
    B, S = tokens.shape
    embed = whole(params["embed"])
    dev = embed.device
    # F.embedding: its backward on the card sums each row's gradients in
    # a fixed order (an indexed read's backward adds them atomically)
    x = F.embedding(tokens.to(dev).long(), embed).to(cfg.act_dtype)
    del embed
    x = shard_act(x, "batch", "model", None)      # sequence parallelism
    tables = rope_tables(torch.arange(S, device=dev)[None], cfg.d_head,
                         cfg.rope_theta, dev)             # positions [1, S]
    caches = [] if collect_cache else None
    aux_total = torch.zeros((), device=dev)

    for pi, kind in enumerate(cfg.pattern):
        window = cfg.window if kind == "l" else 0
        bp = params["blocks"][pi]
        W = min(window or S, S)
        if collect_cache:
            shape = (cfg.n_groups, B, W, cfg.n_kv_heads, cfg.d_head)
            kc = torch.empty(shape, dtype=cfg.act_dtype, device=dev)
            vc = torch.empty_like(kc)
        for gi, lp in enumerate(_unstack(bp, cfg.n_groups)):
            if (torch.is_grad_enabled() and not collect_cache
                    and routing is None):
                # the reference's jax.checkpoint of a group's body: only
                # the layer's input is kept, the rest recomputed in the
                # backward by the same operations (the same bits)
                x, aux, k, v = checkpoint(
                    _layer, lp, x, cfg, tables, window, routing,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, aux, k, v = _layer(lp, x, cfg, tables, window, routing)
            if collect_cache:
                kc[gi] = shard_act(k[:, S - W:], "batch", "model", None,
                                   None)
                vc[gi] = shard_act(v[:, S - W:], "batch", "model", None,
                                   None)
            del k, v
            if aux is not None:
                aux_total = aux_total + aux
        if collect_cache:
            caches.append({"k": kc, "v": vc, "pos": torch.arange(
                S - W, S, dtype=torch.int32, device=dev)})

    if last_only:
        x = x[:, -1:]
    logits = _head(params, x, cfg)
    return logits, aux_total, caches


def lm_loss(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: TransformerConfig, aux_weight: float = 0.01):
    """Mean next-token cross-entropy plus ``aux_weight`` x the aux loss (0
    for a dense model): (loss, {"ce", "aux"}), differentiable in every
    parameter, a MoE model's router and experts included."""
    logits, aux, _ = _forward(params, tokens, cfg)
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        targets.to(logits.device).long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode (single token against KV caches)
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> list:
    """Empty caches: full-length for 'g' positions, a ring of ``window``
    for 'l'; k/v zeros [n_groups, batch, W, KV, dh] in the activation
    dtype, pos -1 [W] int32.  On the card unless ``device`` asks for the
    CPU."""
    device = resolve_device(device)
    caches = []
    for W in cache_widths(cfg, max_len):
        shape = (cfg.n_groups, batch, W, cfg.n_kv_heads, cfg.d_head)
        caches.append({
            "k": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
            "pos": torch.full((W,), -1, dtype=torch.int32, device=device),
        })
    return caches


@torch.inference_mode()
def decode_step(params: dict, caches: list, tokens: torch.Tensor, pos,
                cfg: TransformerConfig, *, routing: list | None = None):
    """One decode step.  tokens [B] int, pos the position of the new token
    (an int or a 0-d tensor).  Writes the new k/v at slot ``pos % W`` of
    each cache in place and returns (logits [B, V], the caches).  An MoE
    layer routes the step's tokens as one group each (never dropping);
    ``routing``, a list, receives each one's ``moe.Routing``."""
    pos = int(pos)
    embed = whole(params["embed"])
    dev = embed.device
    x = embed[tokens.to(dev).long()][:, None, :].to(cfg.act_dtype)
    del embed
    tables = rope_tables(torch.full((1, 1), pos, device=dev), cfg.d_head,
                         cfg.rope_theta, dev)

    for pi, kind in enumerate(cfg.pattern):
        window = cfg.window if kind == "l" else 0
        cache = caches[pi]
        bp = params["blocks"][pi]
        slot = pos % cache["k"].shape[2]
        cache["pos"][slot] = pos
        for gi in range(cfg.n_groups):
            lp = _layer_params(bp, gi)
            q, k, v = _qkv(lp, x, cfg, tables)
            kc, vc = cache["k"][gi], cache["v"][gi]
            kc[:, slot] = k[:, 0]
            vc[:, slot] = v[:, 0]
            o = decode_attention(q, kc, vc, cache["pos"], pos, window=window)
            x = _out_proj(x, o, lp["wo"])
            x, _ = _ffn(lp, x, cfg, routing)

    return _head(params, x, cfg, prefill=False)[:, 0], caches
