"""Model assembly: schema, forward (training and prefill), decode step, loss.

The port of ``repro.models.transformer``, for every family of the
registry: dense GQA language models (internlm2, granite, qwen1.5, starcoder2
and the lm* example configs), the attention-free family (rwkv6),
mixture-of-experts models (mixtral, kimi-k2: ``moe`` in place of the MLP),
the hybrid family (hymba: attention and a selective SSM side by side in
every block), the encoder-decoder (whisper: a non-causal encoder over
``batch["frames"]``, and decoder blocks with cross-attention to its output)
and the vision frontend (internvl2: ``batch["patch_embeds"]`` in front of
the text). The modality frontends themselves are stubs, as in the
reference: frames and patches come in as embeddings (``frontends.py``).

Parameters are the nested dicts of ``schema.init_params`` with the
reference's keys and stacked ``[L, ...]`` layer leaves, in fp32. Layers run
as a Python loop; each layer's master weights are cast to ``cfg.dtype`` as
it runs, as ``repro``'s ``cast_tree`` does inside its layer scan.
Sequence-mode attention (``forward`` and ``loss_fn``: self-attention, the
encoder's and the cross-attention) goes through the flash kernel, forward
and, under autograd, backward (``kernels.flash_attention.kernel.
FlashAttention``); rwkv6's sequence-mode recurrence goes through the WKV6
kernel, forward and, under autograd, backward (``kernels.rwkv6.kernel.
WKV6``). Decode, against the cache, is plain PyTorch.

``loss_fn`` is the reference's: next-token cross entropy in fp32 (labels
below 0 masked; for the vision frontend the text's logits start after the
patches) plus ``AUX_COEF`` times the sum of the layers' MoE load-balance
losses, with each decoder layer recomputed in the backward as
``cfg.remat_policy`` says (``_remat``).

Differences from the reference's API: ``forward`` returns
``(logits, cache)`` (the aux loss, which only training reads, goes to
``loss_fn`` through ``_forward``), and ``decode_step`` updates ``cache`` in
place (the new token's K/V, the recurrent ``wkv``/``tm_prev``/``cm_prev``
leaves, hymba's ``ssm`` state) and returns that same dict (no copy of the
cache per token). whisper's decoder computes each layer's cross K/V from
the encoder output inside the layer loop, not stacked before it as the
reference does (the same values).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels.flash_attention.ops import flash_attention
from ..parallel.sharding import hint
from . import rwkv6, ssm
from .attention import attention_full, attn_schema, out_project, project, qkv_project
from .layers import apply_mlp, apply_norm, mlp_schema, norm_schema, sinusoidal_positions
from .moe import apply_moe, moe_schema
from .schema import P, Schema, abstract_params, init_params, logical_axes, map_tree, stacked

AUX_COEF = 0.01  # MoE load-balance loss coefficient
#: decode-cache leaves that a step overwrites whole (rwkv6's and hymba's
#: recurrent state), unlike the K/V ring, where a step writes one slot
RECURRENT = ("wkv", "tm_prev", "cm_prev", "ssm")


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def cast_tree(tree: dict, dtype: torch.dtype) -> dict:
    """Floating-point leaves cast to the compute dtype (fp32 master
    weights, ``cfg.dtype`` compute)."""
    return map_tree(tree, lambda a: a.to(dtype) if a.is_floating_point() else a)


def layer_params(params: dict, layer: int, dtype: torch.dtype) -> dict:
    """Layer ``layer`` of the stacked ``params["layers"]`` (or of another
    stack of layers, such as ``params["encoder"]``), cast to dtype."""
    return cast_tree(map_tree(params["layers"], lambda a: a[layer]), dtype)


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------
def block_schema(cfg: ModelConfig, *, encoder: bool = False,
                 decoder_cross: bool = False) -> Schema:
    """One block's leaves. Encoder blocks take the MLP and no SSM; decoder
    blocks of an encoder-decoder add ``norm_c`` and ``cross``."""
    if cfg.attention_free:
        return {**rwkv6.rwkv_schema(cfg), "norm1": norm_schema(cfg), "norm2": norm_schema(cfg)}
    s = {"norm1": norm_schema(cfg), "attn": attn_schema(cfg), "norm2": norm_schema(cfg)}
    if cfg.moe is not None and not encoder:
        s["moe"] = moe_schema(cfg)
    else:
        s["mlp"] = mlp_schema(cfg)
    if cfg.hybrid_parallel_ssm and not encoder:
        s["ssm"] = ssm.ssm_schema(cfg)
        s["branch_scale"] = P((2,), (None,), init="ones")
    if decoder_cross:
        s["norm_c"] = norm_schema(cfg)
        s["cross"] = attn_schema(cfg)
    return s


def model_schema(cfg: ModelConfig) -> Schema:
    d, v = cfg.d_model, cfg.vocab_size
    s: Schema = {
        "embed": P((v, d), ("vocab", "embed"), scale=0.02),
        "final_norm": norm_schema(cfg),
        "layers": stacked(block_schema(cfg, decoder_cross=cfg.enc_dec), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        s["unembed"] = P((d, v), ("embed", "vocab"))
    if cfg.enc_dec:
        s["encoder"] = {
            "layers": stacked(block_schema(cfg, encoder=True), cfg.n_encoder_layers),
            "final_norm": norm_schema(cfg),
        }
    return s


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random fp32 master weights from ``torch.Generator(device).manual_seed(seed)``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return init_params(model_schema(cfg), gen, dtype=torch_dtype(cfg.param_dtype))


def abstract_model(cfg: ModelConfig) -> dict:
    """The parameter tree as ``meta`` tensors (shapes and dtypes only)."""
    return abstract_params(model_schema(cfg), dtype=torch_dtype(cfg.param_dtype))


def model_axes(cfg: ModelConfig) -> dict:
    """The parameter tree's logical axis names (``parallel.sharding``)."""
    return logical_axes(model_schema(cfg))


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Shapes/dtypes of the decode cache (leading ``layers`` axis on leaves):
    the K/V ring, and whisper's cross K/V over the ``encoder_seq`` frames."""
    L = cfg.n_layers
    if cfg.attention_free:
        h, n = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
        prev = ((L, batch, cfg.d_model), torch_dtype(cfg.dtype))
        return {"wkv": ((L, batch, h, n, n), torch.float32), "tm_prev": prev, "cm_prev": prev}
    sc = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv = ((L, batch, sc, cfg.n_kv_heads, cfg.head_dim), torch_dtype(cfg.dtype))
    spec = {"k": kv, "v": kv,
            "slot_pos": ((L, batch, sc), torch.int32)}  # per-sequence ring positions
    if cfg.hybrid_parallel_ssm:
        spec["ssm"] = ((L, batch, cfg.ssm.d_inner, cfg.ssm.state_size), torch.float32)
    if cfg.enc_dec:
        spec["ck"] = spec["cv"] = (
            (L, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim), torch_dtype(cfg.dtype))
    return spec


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    dev = resolve_device(device)
    return {k: torch.full(shape, -1 if k == "slot_pos" else 0, dtype=dt, device=dev)
            for k, (shape, dt) in cache_spec(cfg, batch, max_len).items()}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode cache as ``meta`` tensors."""
    return {k: torch.empty(shape, dtype=dt, device="meta")
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


def _cross_kv(cfg, p, enc_out):
    """The encoder output's keys and values for one decoder layer's
    cross-attention: (B, S_enc, Hkv, Dh) each."""
    return project(cfg, p, enc_out, "k"), project(cfg, p, enc_out, "v")


def _cross(cfg, p, x, ke, ve, attend):
    """x + cross-attention of norm_c(x) over (ke, ve) by ``attend``: every
    query sees every frame (no causal mask, no window)."""
    qc = project(cfg, p["cross"], apply_norm(cfg, p["norm_c"], x), "q")
    return x + out_project(cfg, p["cross"], attend(qc, ke, ve, causal=False, window=None))


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


def _ffn(cfg, p, h):
    """Second half of a block: the MLP, or the MoE. Returns (out, the MoE
    load-balance loss, fp32; 0 for the MLP)."""
    if cfg.moe is not None:
        y, aux, _dropped = apply_moe(cfg, p["moe"], h)
        return y, aux.float()
    return apply_mlp(cfg, p["mlp"], h), h.new_zeros((), dtype=torch.float32)


def _mix(cfg, p, x, a, sy):
    """hymba's parallel branches: x + (s0·attn + s1·ssm) / 2."""
    scale = p["branch_scale"].to(x.dtype)
    return x + 0.5 * (scale[0] * a + scale[1] * sy)


def block_seq(cfg: ModelConfig, p, x, positions, *, causal=True, emit_cache=False,
              enc_out=None):
    """One block over a full sequence (an encoder block with
    ``causal=False``). Returns (x, this layer's cache leaves or None, its
    MoE aux loss): the leaves {"k", "v"} for attention (and "ssm" for
    hymba, "ck", "cv" for a decoder block given ``enc_out``), {"wkv",
    "tm_prev", "cm_prev"} for rwkv6."""
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
        return x + y, (emit if emit_cache else None), x.new_zeros((), dtype=torch.float32)
    h = apply_norm(cfg, p["norm1"], x)
    a, (k, v) = _attn_seq(cfg, p["attn"], h, positions, causal=causal)
    emit = {"k": k, "v": v}
    if cfg.hybrid_parallel_ssm:
        s0 = torch.zeros((x.shape[0], cfg.ssm.d_inner, cfg.ssm.state_size),
                         dtype=torch.float32, device=x.device)
        sy, emit["ssm"] = ssm.apply_ssm(cfg, p["ssm"], h, s0)
        x = _mix(cfg, p, x, a, sy)
    else:
        x = x + a
    if enc_out is not None:  # whisper's decoder: cross-attention to the encoder
        emit["ck"], emit["cv"] = _cross_kv(cfg, p["cross"], enc_out)
        x = _cross(cfg, p, x, emit["ck"], emit["cv"], flash_attention)
    y, aux = _ffn(cfg, p, apply_norm(cfg, p["norm2"], x))
    return x + y, (emit if emit_cache else None), aux


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
    a = _attn_step(cfg, p["attn"], h, pos, cache_l["k"], cache_l["v"],
                   cache_l["slot_pos"], window=cfg.sliding_window)
    if cfg.hybrid_parallel_ssm:
        sy, state = ssm.apply_ssm_step(cfg, p["ssm"], h, cache_l["ssm"])
        cache_l["ssm"].copy_(state)
        x = _mix(cfg, p, x, a, sy)
    else:
        x = x + a
    if cfg.enc_dec:
        x = _cross(cfg, p, x, cache_l["ck"], cache_l["cv"], attention_full)
    return x + _ffn(cfg, p, apply_norm(cfg, p["norm2"], x))[0]


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------
def run_encoder(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, d) in the compute dtype -> the encoder output: the
    frames plus sinusoidal positions, the encoder blocks with non-causal
    self-attention (through the flash kernel), the encoder's final norm."""
    dtype = torch_dtype(cfg.dtype)
    enc = params["encoder"]
    h = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      device=frames.device).to(frames.dtype)
    h = hint(h, ("batch", "seq", "embed"))
    positions = torch.arange(h.shape[1], device=h.device)
    for layer in range(cfg.n_encoder_layers):
        h = block_seq(cfg, layer_params(enc, layer, dtype), h, positions, causal=False)[0]
    return apply_norm(cfg, enc["final_norm"], h)


# ---------------------------------------------------------------------------
# Forward / loss / decode
# ---------------------------------------------------------------------------
def _embed_tokens(cfg, params, tokens):
    return params["embed"][tokens.long()].to(torch_dtype(cfg.dtype))


def _unembed(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return h @ w.to(h.dtype)


#: the operations whose outputs the "dots" policy keeps for the backward: the
#: products with a weight (2-d matrix products; attention's and the
#: experts' batched products are recomputed), as the reference's
#: ``dots_with_no_batch_dims_saveable``
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` with its activations recomputed in the backward as
    ``cfg.remat_policy`` says: "full" keeps none of them (a checkpoint a
    layer), "dots" keeps the products with a weight (selective
    checkpointing), anything else ("nothing") keeps every one."""
    if cfg.remat_policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat_policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    return fn


def _forward(cfg: ModelConfig, params, batch: dict, *, emit_cache: bool = False,
             logits_mode: str = "all", remat: bool = False):
    """``forward``, and the sum of the layers' MoE aux losses (fp32):
    (logits, cache or None, aux). ``remat`` recomputes each decoder layer
    in the backward by ``_remat``."""
    dtype = torch_dtype(cfg.dtype)
    enc_out = None
    h = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.enc_dec:
        enc_out = run_encoder(cfg, params, batch["frames"].to(dtype))
    elif cfg.frontend == "vision":
        h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
    if not cfg.use_rope:  # whisper's decoder too: positions added once
        h = h + sinusoidal_positions(h.shape[1], cfg.d_model, device=h.device).to(h.dtype)
    h = hint(h, ("batch", "seq", "embed"))
    positions = torch.arange(h.shape[1], device=h.device)

    def layer_fn(x, layer):
        x, emit, aux_l = block_seq(cfg, layer_params(params, layer, dtype), x, positions,
                                   causal=True, emit_cache=emit_cache, enc_out=enc_out)
        return hint(x, ("batch", "seq", "embed")), emit, aux_l

    body = _remat(cfg, layer_fn) if remat else layer_fn
    aux = h.new_zeros((), dtype=torch.float32)
    emits = []
    for layer in range(cfg.n_layers):
        h, emit, aux_l = body(h, layer)
        aux = aux + aux_l
        emits.append(emit)
    h = apply_norm(cfg, params["final_norm"], h)
    if logits_mode == "last":
        h = h[:, -1:, :]
    logits = hint(_unembed(cfg, params, h), ("batch", "seq", "vocab"))
    cache = None
    if emit_cache:
        cache = _assemble_cache(cfg, {name: torch.stack([e[name] for e in emits])
                                      for name in emits[0]})
    return logits, cache, aux


def forward(cfg: ModelConfig, params, batch: dict, *, emit_cache: bool = False,
            logits_mode: str = "all"):
    """``batch`` -> (logits (B, S or 1, V), cache or None). Its keys by
    family (``frontends.input_specs``):

    LM:     tokens (B, S)
    vision: tokens (B, S_text) + patch_embeds (B, P, d), S = P + S_text
    audio:  tokens (B, S) + frames (B, S_enc, d)

    ``logits_mode="last"`` unembeds only the final position (prefill needs
    only the next-token distribution).
    """
    logits, cache, _aux = _forward(cfg, params, batch, emit_cache=emit_cache,
                                   logits_mode=logits_mode)
    return logits, cache


def loss_fn(cfg: ModelConfig, params, batch: dict, *, remat: bool = True):
    """Next-token cross entropy (fp32) over ``batch["labels"]`` (B, S_text;
    labels below 0 masked), plus ``AUX_COEF`` times the MoE aux loss.
    Returns (loss, {"ce", "aux", "tokens"}), as the reference's. For the
    vision frontend, position P - 1 + j of the P patches and the text
    predicts text token j."""
    logits, _, aux = _forward(cfg, params, batch, remat=remat)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        p_len = batch["patch_embeds"].shape[1]
        logits = logits[:, p_len - 1:p_len - 1 + labels.shape[1]]
    lf = logits.float()
    mask = (labels >= 0).float()
    gold = lf.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    ce = (torch.logsumexp(lf, dim=-1) - gold) * mask
    ntok = mask.sum().clamp_min(1.0)
    loss = ce.sum() / ntok
    return loss + AUX_COEF * aux, {"ce": loss, "aux": aux, "tokens": ntok}


def _assemble_cache(cfg: ModelConfig, emits: dict) -> dict:
    """Per-layer leaves stacked on a leading layer axis -> the decode cache
    layout: rwkv6's and hymba's recurrent state and whisper's cross K/V
    as they are; keys/values (L, B, S, Hkv, Dh) with their ring
    positions."""
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
    return {**emits, "k": k, "v": v, "slot_pos": slot_pos}


def decode_step(cfg: ModelConfig, params, cache: dict, tokens, pos):
    """One token for every sequence. tokens: (B, 1); pos: an int or a (B,)
    tensor of per-sequence absolute positions (continuous batching).
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    dtype = torch_dtype(cfg.dtype)
    b = tokens.shape[0]
    dev = next(iter(cache.values())).device
    pos = torch.as_tensor(pos, device=dev).to(torch.int32).expand(b).contiguous()
    h = _embed_tokens(cfg, params, tokens.to(dev))
    if not cfg.use_rope:
        pe = torch.stack([sinusoidal_positions(1, cfg.d_model, offset=o, device=dev)
                          for o in pos])
        h = h + pe.to(h.dtype)
    h = hint(h, ("batch", None, "embed"))
    for layer in range(cfg.n_layers):
        cache_l = {name: leaf[layer] for name, leaf in cache.items()}
        h = hint(block_step(cfg, layer_params(params, layer, dtype), h, pos, cache_l),
                 ("batch", None, "embed"))
    h = apply_norm(cfg, params["final_norm"], h)
    return _unembed(cfg, params, h), cache
