"""Model assembly: schema, forward (prefill), decode step.

The port of ``repro.models.transformer`` for dense GQA language models
(internlm2, granite, qwen1.5, starcoder2 and the lm* example configs) and
the attention-free family (rwkv6). The other families raise
``NotImplementedError`` (``ROADMAP.md``, queue 1).

Parameters are the nested dicts of ``schema.init_params`` with the
reference's keys and stacked ``[L, ...]`` layer leaves, in fp32. Layers run
as a Python loop; each layer's master weights are cast to ``cfg.dtype`` as
it runs, as ``repro``'s ``cast_tree`` does inside its layer scan.
Sequence-mode attention (``forward``, prefill) goes through the flash
kernel, and rwkv6's sequence-mode recurrence through the WKV6 kernel;
decode, against the cache, is plain PyTorch.

Differences from the reference's API: ``forward`` returns
``(logits, cache)`` (these families have no auxiliary loss), and
``decode_step`` updates ``cache`` in place (the new token's K/V, or the
recurrent ``wkv``/``tm_prev``/``cm_prev`` leaves) and returns that same dict
(no copy of the cache per token).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels.flash_attention.ops import flash_attention
from . import rwkv6
from .attention import attn_schema, out_project, qkv_project
from .layers import apply_mlp, apply_norm, mlp_schema, norm_schema, sinusoidal_positions
from .schema import P, Schema, init_params, stacked

#: ModelConfig fields that select a family the port does not run yet
UNPORTED = ("moe", "hybrid_parallel_ssm", "enc_dec", "frontend")
#: decode-cache leaves that a step overwrites whole (rwkv6's recurrent state),
#: unlike the K/V ring, where a step writes one slot
RECURRENT = ("wkv", "tm_prev", "cm_prev")


def check_family(cfg: ModelConfig) -> None:
    found = [name for name in UNPORTED if getattr(cfg, name)]
    if found:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(found)} is not ported to repro_torch yet "
            f"(the dense and attention-free families are; see ROADMAP.md, queue 1)"
        )


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _map_tree(tree: dict, fn) -> dict:
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def cast_tree(tree: dict, dtype: torch.dtype) -> dict:
    """Floating-point leaves cast to the compute dtype (fp32 master
    weights, ``cfg.dtype`` compute)."""
    return _map_tree(tree, lambda a: a.to(dtype) if a.is_floating_point() else a)


def layer_params(params: dict, layer: int, dtype: torch.dtype) -> dict:
    """Layer ``layer`` of the stacked ``params["layers"]``, cast to dtype."""
    return cast_tree(_map_tree(params["layers"], lambda a: a[layer]), dtype)


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------
def block_schema(cfg: ModelConfig) -> Schema:
    check_family(cfg)
    if cfg.attention_free:
        return {**rwkv6.rwkv_schema(cfg), "norm1": norm_schema(cfg), "norm2": norm_schema(cfg)}
    return {"norm1": norm_schema(cfg), "attn": attn_schema(cfg),
            "norm2": norm_schema(cfg), "mlp": mlp_schema(cfg)}


def model_schema(cfg: ModelConfig) -> Schema:
    d, v = cfg.d_model, cfg.vocab_size
    s: Schema = {
        "embed": P((v, d), ("vocab", "embed"), scale=0.02),
        "final_norm": norm_schema(cfg),
        "layers": stacked(block_schema(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        s["unembed"] = P((d, v), ("embed", "vocab"))
    return s


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random fp32 master weights from ``torch.Generator(device).manual_seed(seed)``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return init_params(model_schema(cfg), gen, dtype=torch_dtype(cfg.param_dtype))


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Shapes/dtypes of the decode cache (leading ``layers`` axis on leaves)."""
    check_family(cfg)
    L = cfg.n_layers
    if cfg.attention_free:
        h, n = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
        prev = ((L, batch, cfg.d_model), torch_dtype(cfg.dtype))
        return {"wkv": ((L, batch, h, n, n), torch.float32), "tm_prev": prev, "cm_prev": prev}
    sc = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv = ((L, batch, sc, cfg.n_kv_heads, cfg.head_dim), torch_dtype(cfg.dtype))
    return {"k": kv, "v": kv,
            "slot_pos": ((L, batch, sc), torch.int32)}  # per-sequence ring positions


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    dev = resolve_device(device)
    return {k: torch.full(shape, -1 if k == "slot_pos" else 0, dtype=dt, device=dev)
            for k, (shape, dt) in cache_spec(cfg, batch, max_len).items()}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _attn_seq(cfg, p, h, positions, *, causal=True):
    """Sequence-mode attention through the flash kernel; returns
    (out, (k, v)) for cache emission."""
    q, k, v = qkv_project(cfg, p, h, positions if cfg.use_rope else None)
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return out_project(cfg, p, o), (k, v)


def _attn_step(cfg, p, h, pos, kc, vc, slot_pos, *, window):
    """Decode-mode attention against a (ring-buffer) cache, written in
    place. ``pos`` is a (B,) int32 vector of per-sequence absolute
    positions: continuous-batching serving decodes lanes at different
    depths."""
    q, k, v = qkv_project(cfg, p, h, pos[:, None] if cfg.use_rope else None)
    lanes = torch.arange(pos.shape[0], device=pos.device)
    slot = (pos % kc.shape[1]).long()
    kc[lanes, slot] = k[:, 0]
    vc[lanes, slot] = v[:, 0]
    slot_pos[lanes, slot] = pos
    o = _cache_attention(q, kc, vc, slot_pos, pos, window)
    return out_project(cfg, p, o)


def _cache_attention(q, kc, vc, slot_pos, pos, window):
    """q: (B,1,Hq,Dh); kc/vc: (B,Sc,Hkv,Dh); slot_pos: (B,Sc) absolute
    positions per lane; pos: (B,)."""
    b, _, hq, dh = q.shape
    hkv = kc.shape[2]
    qg = q.reshape(b, 1, hkv, hq // hkv, dh)
    s = torch.einsum("bsngk,btnk->bngst", qg.float(), kc.float()) * dh**-0.5
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window is not None:
        valid &= slot_pos > (pos[:, None] - window)
    s = torch.where(valid[:, None, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bngst,btnk->bsngk", pr, vc.float())
    return o.reshape(b, 1, hq, dh).to(q.dtype)


def block_seq(cfg: ModelConfig, p, x, positions, *, causal=True, emit_cache=False):
    """One decoder block over a full sequence. Returns (x, this layer's cache
    leaves or None): {"k", "v"} for attention, {"wkv", "tm_prev", "cm_prev"}
    for rwkv6."""
    if cfg.attention_free:
        b = x.shape[0]
        h, n = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
        pv0 = x.new_zeros((b, cfg.d_model))
        st0 = torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
        y, tm_prev, wkv = rwkv6.apply_time_mix(cfg, p["tm"], apply_norm(cfg, p["norm1"], x),
                                               pv0, st0)
        x = x + y
        y, cm_prev = rwkv6.apply_channel_mix(cfg, p["cm"], apply_norm(cfg, p["norm2"], x), pv0)
        emit = {"wkv": wkv, "tm_prev": tm_prev, "cm_prev": cm_prev}
        return x + y, (emit if emit_cache else None)
    h = apply_norm(cfg, p["norm1"], x)
    a, (k, v) = _attn_seq(cfg, p["attn"], h, positions, causal=causal)
    x = x + a
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
    return x, ({"k": k, "v": v} if emit_cache else None)


def block_step(cfg: ModelConfig, p, x, pos, cache_l) -> torch.Tensor:
    """One decoder block for a single decode step; ``cache_l`` (this layer's
    views of the cache leaves) is updated in place."""
    if cfg.attention_free:
        y, tm_prev, wkv = rwkv6.apply_time_mix_step(
            cfg, p["tm"], apply_norm(cfg, p["norm1"], x), cache_l["tm_prev"], cache_l["wkv"])
        x = x + y
        y, cm_prev = rwkv6.apply_channel_mix_step(
            cfg, p["cm"], apply_norm(cfg, p["norm2"], x), cache_l["cm_prev"])
        for name, new in zip(RECURRENT, (wkv, tm_prev, cm_prev)):
            cache_l[name].copy_(new)
        return x + y
    h = apply_norm(cfg, p["norm1"], x)
    x = x + _attn_step(cfg, p["attn"], h, pos, cache_l["k"], cache_l["v"],
                       cache_l["slot_pos"], window=cfg.sliding_window)
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))


# ---------------------------------------------------------------------------
# Forward / decode
# ---------------------------------------------------------------------------
def _embed_tokens(cfg, params, tokens):
    return params["embed"][tokens.long()].to(torch_dtype(cfg.dtype))


def _unembed(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return h @ w.to(h.dtype)


def forward(cfg: ModelConfig, params, batch: dict, *, emit_cache: bool = False,
            logits_mode: str = "all"):
    """``batch["tokens"]`` (B, S) -> (logits (B, S or 1, V), cache or None).

    ``logits_mode="last"`` unembeds only the final position (prefill needs
    only the next-token distribution).
    """
    check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    h = _embed_tokens(cfg, params, batch["tokens"])
    if not cfg.use_rope:
        h = h + sinusoidal_positions(h.shape[1], cfg.d_model, device=h.device).to(h.dtype)
    positions = torch.arange(h.shape[1], device=h.device)
    emits = []
    for layer in range(cfg.n_layers):
        h, emit = block_seq(cfg, layer_params(params, layer, dtype), h, positions,
                            causal=True, emit_cache=emit_cache)
        emits.append(emit)
    h = apply_norm(cfg, params["final_norm"], h)
    if logits_mode == "last":
        h = h[:, -1:, :]
    logits = _unembed(cfg, params, h)
    cache = None
    if emit_cache:
        cache = _assemble_cache(cfg, {name: torch.stack([e[name] for e in emits])
                                      for name in emits[0]})
    return logits, cache


def _assemble_cache(cfg: ModelConfig, emits: dict) -> dict:
    """Per-layer leaves stacked on a leading layer axis -> the decode cache
    layout: rwkv6's recurrent state as it is; keys/values (L, B, S, Hkv, Dh)
    with their ring positions."""
    if cfg.attention_free:
        return emits
    k, v = emits["k"], emits["v"]
    L, b, seq_len = k.shape[:3]
    sc = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    if sc < seq_len:  # keep the last `window` keys, slot = pos % sc
        start = seq_len - sc
        pos = torch.arange(start, seq_len, device=k.device)
        order = torch.argsort(pos % sc)
        k, v = k[:, :, start:][:, :, order], v[:, :, start:][:, :, order]
        slot_pos = pos[order]
    else:
        slot_pos = torch.arange(sc, device=k.device)
    slot_pos = slot_pos.to(torch.int32).expand(L, b, sc).contiguous()
    return {"k": k, "v": v, "slot_pos": slot_pos}


def decode_step(cfg: ModelConfig, params, cache: dict, tokens, pos):
    """One token for every sequence. tokens: (B, 1); pos: an int or a (B,)
    tensor of per-sequence absolute positions (continuous batching).
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    b = tokens.shape[0]
    dev = next(iter(cache.values())).device
    pos = torch.as_tensor(pos, device=dev).to(torch.int32).expand(b).contiguous()
    h = _embed_tokens(cfg, params, tokens.to(dev))
    if not cfg.use_rope:
        pe = torch.stack([sinusoidal_positions(1, cfg.d_model, offset=o, device=dev)
                          for o in pos])
        h = h + pe.to(h.dtype)
    for layer in range(cfg.n_layers):
        cache_l = {name: leaf[layer] for name, leaf in cache.items()}
        h = block_step(cfg, layer_params(params, layer, dtype), h, pos, cache_l)
    h = apply_norm(cfg, params["final_norm"], h)
    return _unembed(cfg, params, h), cache
