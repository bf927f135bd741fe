"""Plain reference of a dense decoder (internlm2): RMSNorm, GQA attention
with rotary positions, a SwiGLU MLP, untied output head.

The configuration as run: pre-norm blocks x + attn(norm1(x)) and x +
mlp(norm2(x)); RMSNorm x · rsqrt(mean(x²) + eps) · scale; q, k, v
projections, the halves of each head rotated (rope_theta), causal softmax
attention at 1/√d_head, a query head reading key head h // (Hq / Hkv); MLP
(silu(x W1) · (x W3)) W2; a final RMSNorm and the head x · unembed.

fp32 throughout (or with fp8 products for the control), one layer at a
time. Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import act, causal_attention, mm, rms_norm, rope

#: standard deviation of the embedding rows
EMBED_STD = 0.02
#: spread of the norms' scales around 1
SCALE_NOISE = 0.1


def leaves(m: dict) -> list:
    """The program's parameter tree for this family: (path, shape, init)."""
    L, d, f, V = m["n_layers"], m["d_model"], m["d_ff"], m["vocab_size"]
    hq, hkv, dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    out = [
        (("embed",), (V, d), ("normal", EMBED_STD)),
        (("final_norm", "scale"), (d,), ("scale", SCALE_NOISE)),
        (("layers", "attn", "wk"), (L, d, hkv, dh), ("normal", d ** -0.5)),
        (("layers", "attn", "wo"), (L, hq, dh, d), ("normal", (hq * dh) ** -0.5)),
        (("layers", "attn", "wq"), (L, d, hq, dh), ("normal", d ** -0.5)),
        (("layers", "attn", "wv"), (L, d, hkv, dh), ("normal", d ** -0.5)),
        (("layers", "mlp", "w1"), (L, d, f), ("normal", d ** -0.5)),
        (("layers", "mlp", "w2"), (L, f, d), ("normal", f ** -0.5)),
        (("layers", "mlp", "w3"), (L, d, f), ("normal", d ** -0.5)),
        (("layers", "norm1", "scale"), (L, d), ("scale", SCALE_NOISE)),
        (("layers", "norm2", "scale"), (L, d), ("scale", SCALE_NOISE)),
        (("unembed",), (d, V), ("normal", d ** -0.5)),
    ]
    return sorted(out)


def _layer(m, W, i, x, quant, emit=None):
    a, mlp = W["layers"]["attn"], W["layers"]["mlp"]
    b, s, d = x.shape
    hq, hkv, dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    eps = m["norm_eps"]
    h = act(rms_norm(x, W["layers"]["norm1"]["scale"][i], eps), quant)
    q = mm(h, a["wq"][i].reshape(d, hq * dh), quant).view(b, s, hq, dh)
    k = mm(h, a["wk"][i].reshape(d, hkv * dh), quant).view(b, s, hkv, dh)
    v = mm(h, a["wv"][i].reshape(d, hkv * dh), quant).view(b, s, hkv, dh)
    q, k = act(rope(q, m["rope_theta"]), quant), act(rope(k, m["rope_theta"]), quant)
    if emit is not None:
        emit(i, {"k": k, "v": v})
    o = act(causal_attention(q, k, v), quant)
    x = act(x + mm(o.reshape(b, s, hq * dh), a["wo"][i].reshape(hq * dh, d), quant), quant)
    h = act(rms_norm(x, W["layers"]["norm2"]["scale"][i], eps), quant)
    gate = act(F.silu(mm(h, mlp["w1"][i], quant)) * mm(h, mlp["w3"][i], quant), quant)
    return act(x + mm(gate, mlp["w2"][i], quant), quant)


def hidden(m: dict, W: dict, tokens: torch.Tensor, quant=None, emit=None,
           remat: bool = False) -> torch.Tensor:
    """tokens (B, S) -> the final norm's output (B, S, d). ``emit(layer,
    leaves)`` sees each layer's cache leaves (k after its rotation, v);
    ``remat`` recomputes each layer in the backward."""
    x = act(W["embed"][tokens.long()], quant)
    for i in range(m["n_layers"]):
        if remat:
            x = checkpoint(_layer, m, W, i, x, quant, use_reentrant=False)
        else:
            x = _layer(m, W, i, x, quant, emit)
    return act(rms_norm(x, W["final_norm"]["scale"], m["norm_eps"]), quant)


def logits(m: dict, W: dict, h: torch.Tensor, quant=None) -> torch.Tensor:
    return mm(h, W["unembed"], quant)
