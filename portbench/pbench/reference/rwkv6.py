"""Plain reference of the RWKV6 (Finch) model as the configuration runs it.

Blocks x + time_mix(norm1(x)) and x + channel_mix(norm2(x)), RMSNorm;
absolute sinusoidal positions added to the embedding (the port's rule for a
model without rotary positions, ``use_rope`` false). Time mix: each of r, k, v, g, w reads x + (x₋₁ - x) · μ
(a static mix a channel, x₋₁ the previous token's input); r, k, v, g by
products with a weight, g through SiLU; log w = -exp(w0 + tanh(x_w Wa) Wb);
per head of N channels the WKV recurrence

    o_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t),    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

from S_{-1} = 0; a layer norm a head (scale, no bias, eps 1e-5) on o, times
g, through Wo. Channel mix: sigmoid(x_r Wr) · (relu(x_k Wk)² Wv). The
recurrence is computed exactly in a chunked form: within a chunk each pair
of positions decays by exp of a difference of cumulative log decays (never
a ratio), and the state crosses chunks in a loop.

fp32 throughout (or with fp8 products for the control). Imports nothing of
the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import act, mm, rms_norm, sinusoidal, token_shift

#: embedding rows N(0, 1): the program adds sinusoidal positions of magnitude
#: ~1 to the embedding in its compute dtype, so a row at 0.02 would keep few
#: of its bits beside them in bf16
EMBED_STD = 1.0
SCALE_NOISE = 0.1
#: the bonus u and the token-shift mixes: uniform on these ranges
U_RANGE = (-0.5, 0.5)
MU_RANGE = (0.0, 1.0)
#: the decay's low-rank factors (small, so that w stays near its base)
LORA_STD = 0.01
#: positions a chunk of the exact chunked WKV; chunks a block without a gradient
CHUNK = 32
BLOCK_CHUNKS = 128
HEAD_NORM_EPS = 1e-5


def leaves(m: dict) -> list:
    """The program's parameter tree for this family. The two products that
    write into the residual stream (the time mix's Wo, the channel mix's
    Wv) are scaled by 1/√(2L), as deep residual models are initialised, so
    that 32 layers of random weights do not blow up the backward."""
    L, d, f, V = m["n_layers"], m["d_model"], m["d_ff"], m["vocab_size"]
    lora = m["rwkv"]["decay_lora"]
    out_scale = (2 * L) ** -0.5
    tm, cm = ("layers", "tm"), ("layers", "cm")
    out = [
        (("embed",), (V, d), ("normal", EMBED_STD)),
        (("final_norm", "scale"), (d,), ("scale", SCALE_NOISE)),
        (("layers", "norm1", "scale"), (L, d), ("scale", SCALE_NOISE)),
        (("layers", "norm2", "scale"), (L, d), ("scale", SCALE_NOISE)),
        (tm + ("mu",), (L, 5, d), ("uniform", *MU_RANGE)),
        (tm + ("wr",), (L, d, d), ("normal", d ** -0.5)),
        (tm + ("wk",), (L, d, d), ("normal", d ** -0.5)),
        (tm + ("wv",), (L, d, d), ("normal", d ** -0.5)),
        (tm + ("wg",), (L, d, d), ("normal", d ** -0.5)),
        (tm + ("wo",), (L, d, d), ("normal", out_scale * d ** -0.5)),
        (tm + ("w0",), (L, d), ("decay_base",)),
        (tm + ("wa",), (L, d, lora), ("normal", LORA_STD)),
        (tm + ("wb",), (L, lora, d), ("normal", LORA_STD)),
        (tm + ("u",), (L, d), ("uniform", *U_RANGE)),
        (tm + ("ln",), (L, d), ("scale", SCALE_NOISE)),
        (cm + ("mu",), (L, 2, d), ("uniform", *MU_RANGE)),
        (cm + ("wk",), (L, d, f), ("normal", d ** -0.5)),
        (cm + ("wv",), (L, f, d), ("normal", out_scale * f ** -0.5)),
        (cm + ("wr",), (L, d, d), ("normal", d ** -0.5)),
        (("unembed",), (d, V), ("normal", d ** -0.5)),
    ]
    return sorted(out)


def _wkv_chunks(r, k, v, lw, u, state):
    """One block of whole chunks. r, k, v, lw: (BH, nc, C, N); u (BH, N);
    state (BH, N, N) -> (o (BH, nc, C, N), state after the block)."""
    c = lw.cumsum(2)            # Σ_{q ≤ t} log w_q within the chunk
    cp = c - lw                 # Σ_{q < t}
    t = torch.arange(r.shape[2], device=r.device)
    before = (t[None, :] < t[:, None])[None, None, :, :, None]  # s < t
    expo = torch.where(before, cp[:, :, :, None, :] - c[:, :, None, :, :], float("-inf"))
    a = (r[:, :, :, None, :] * k[:, :, None, :, :] * torch.exp(expo)).sum(-1)
    o = a @ v + (r * u[:, None, None, :] * k).sum(-1, keepdim=True) * v
    kd = k * torch.exp(c[:, :, -1:, :] - c)
    upd = kd.transpose(-1, -2) @ v                  # (BH, nc, N, N)
    dec = torch.exp(c[:, :, -1, :])                 # (BH, nc, N)
    starts = []
    for j in range(r.shape[1]):
        starts.append(state)
        state = dec[:, j, :, None] * state + upd[:, j]
    o = o + (r * torch.exp(cp)) @ torch.stack(starts, 1)
    return o, state


def wkv(r, k, v, lw, u, state=None):
    """r, k, v, log w: (BH, S, N) fp32; u (BH, N) -> (o (BH, S, N), final
    state (BH, N, N)). Padded positions (k = 0, log w = 0) add nothing."""
    bh, s, n = r.shape
    pad = (-s) % CHUNK
    if pad:
        r, k, v, lw = (F.pad(x, (0, 0, 0, pad)) for x in (r, k, v, lw))
    nc = (s + pad) // CHUNK
    shape = (bh, nc, CHUNK, n)
    r, k, v, lw = (x.reshape(shape) for x in (r, k, v, lw))
    if state is None:
        state = r.new_zeros((bh, n, n))
    step = nc if torch.is_grad_enabled() else BLOCK_CHUNKS
    outs = []
    for j0 in range(0, nc, step):
        sl = slice(j0, j0 + step)
        o, state = _wkv_chunks(r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u, state)
        outs.append(o)
    o = torch.cat(outs, 1).reshape(bh, nc * CHUNK, n)[:, :s]
    return o, state


def _heads(x, h, n):
    """(B, S, H·N) -> (B·H, S, N)."""
    b, s, _ = x.shape
    return x.reshape(b, s, h, n).transpose(1, 2).reshape(b * h, s, n)


def _time_mix(m, p, i, x, quant, emit_state):
    b, s, d = x.shape
    n = m["rwkv"]["head_size"]
    h = d // n
    xs = token_shift(x)
    mu = p["mu"][i]
    xr, xk, xv, xg, xw = (act(x + (xs - x) * mu[j], quant) for j in range(5))
    r = mm(xr, p["wr"][i], quant)
    k = mm(xk, p["wk"][i], quant)
    v = mm(xv, p["wv"][i], quant)
    g = act(F.silu(mm(xg, p["wg"][i], quant)), quant)
    lw = -torch.exp(p["w0"][i] + mm(torch.tanh(mm(xw, p["wa"][i], quant)), p["wb"][i], quant))
    u = p["u"][i].reshape(h, n).repeat(b, 1)
    o, state = wkv(_heads(r, h, n), _heads(k, h, n), _heads(v, h, n), _heads(lw, h, n), u)
    o = act(o.reshape(b, h, s, n).transpose(1, 2), quant)       # (B, S, H, N)
    mean = o.mean(-1, keepdim=True)
    var = (o - mean).square().mean(-1, keepdim=True)
    o = act(((o - mean) * torch.rsqrt(var + HEAD_NORM_EPS)).reshape(b, s, d) * p["ln"][i], quant)
    emit_state["wkv"] = state.reshape(b, h, n, n)
    emit_state["tm_prev"] = x[:, -1]
    return mm(act(o * g, quant), p["wo"][i], quant)


def _channel_mix(m, p, i, x, quant, emit_state):
    xs = token_shift(x)
    mu = p["mu"][i]
    xk = act(x + (xs - x) * mu[0], quant)
    xr = act(x + (xs - x) * mu[1], quant)
    kk = act(F.relu(mm(xk, p["wk"][i], quant)).square(), quant)
    emit_state["cm_prev"] = x[:, -1]
    return act(torch.sigmoid(mm(xr, p["wr"][i], quant)) * mm(kk, p["wv"][i], quant), quant)


def _layer(m, W, i, x, quant, emit=None):
    lay = W["layers"]
    eps = m["norm_eps"]
    st: dict = {}
    h = act(rms_norm(x, lay["norm1"]["scale"][i], eps), quant)
    x = act(x + _time_mix(m, lay["tm"], i, h, quant, st), quant)
    h = act(rms_norm(x, lay["norm2"]["scale"][i], eps), quant)
    x = act(x + _channel_mix(m, lay["cm"], i, h, quant, st), quant)
    if emit is not None:
        emit(i, st)
    return x


def hidden(m: dict, W: dict, tokens: torch.Tensor, quant=None, emit=None,
           remat: bool = False) -> torch.Tensor:
    """tokens (B, S) -> the final norm's output (B, S, d). ``emit(layer,
    leaves)`` sees each layer's recurrent state after the prompt: ``wkv``
    (B, H, N, N) and the last normed inputs of the two mixes ``tm_prev``
    and ``cm_prev`` (B, d)."""
    x = act(act(W["embed"][tokens.long()], quant)
            + sinusoidal(tokens.shape[1], m["d_model"], W["embed"].device), quant)
    for i in range(m["n_layers"]):
        if remat:
            x = checkpoint(_layer, m, W, i, x, quant, use_reentrant=False)
        else:
            x = _layer(m, W, i, x, quant, emit)
    return act(rms_norm(x, W["final_norm"]["scale"], m["norm_eps"]), quant)


def logits(m: dict, W: dict, h: torch.Tensor, quant=None) -> torch.Tensor:
    return mm(h, W["unembed"], quant)
