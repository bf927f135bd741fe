"""The yardstick's counts: model FLOPs, and each kernel's least time.

Everything here is worked out from a configuration file's shapes and the
published peaks of one NVIDIA H100 SXM (dense rates, no sparsity, at its
700 W limit). Nothing is read from the program.

The FLOP rule: 2 FLOP per matrix weight per token forward, 6 for training.
The input embedding is a lookup and is not counted; the output head is a
matrix weight. Attention adds 4·d_head FLOP for each live causal pair and
head forward (Q·K and P·V), three times that for training. Recomputation
is not counted. In prefill the output head counts for the last position
only, since that is all a user needs.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def dense_layer_weights(m: dict) -> int:
    """Matrix weights of one dense GQA layer (q, k, v, o and a gated MLP)."""
    d, dh, hq, hkv, f = m["d_model"], m["d_head"], m["n_heads"], m["n_kv_heads"], m["d_ff"]
    attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    return attn + (3 if m.get("mlp_gated", True) else 2) * d * f


def rwkv6_layer_weights(m: dict) -> int:
    """Matrix weights of one RWKV6 layer as the configuration runs it: the
    time mix's r, k, v, g, o and the decay's two low-rank factors; the
    channel mix's k, v and r."""
    d, f, lora = m["d_model"], m["d_ff"], m["rwkv"]["decay_lora"]
    return 5 * d * d + 2 * d * lora + 2 * d * f + d * d


def layer_weights(m: dict) -> int:
    return rwkv6_layer_weights(m) if m.get("attention_free") else dense_layer_weights(m)


def body_weights(m: dict) -> int:
    """Matrix weights a token meets in the layers (no embedding, no head)."""
    return m["n_layers"] * layer_weights(m)


def head_weights(m: dict) -> int:
    return m["d_model"] * m["vocab_size"]


def causal_pairs(s: int) -> int:
    """Live (query, key) pairs of one causal sequence of s tokens."""
    return s * (s + 1) // 2


def attention_flops_fwd(m: dict, rows: int, s: int) -> int:
    """Forward attention FLOPs over ``rows`` sequences of s tokens, every
    layer (0 for an attention-free model)."""
    if m.get("attention_free"):
        return 0
    return 4 * m["d_head"] * m["n_heads"] * causal_pairs(s) * rows * m["n_layers"]


def train_step_flops(m: dict, rows: int, s: int) -> int:
    """Model FLOPs of one training step over rows × s tokens."""
    tokens = rows * s
    return 6 * (body_weights(m) + head_weights(m)) * tokens + 3 * attention_flops_fwd(m, rows, s)


def prefill_flops(m: dict, s: int) -> int:
    """Model FLOPs of one prompt of s tokens: every position through the
    layers, the head for the last position only."""
    return 2 * body_weights(m) * s + 2 * head_weights(m) + attention_flops_fwd(m, 1, s)


def least_ms(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3


# ---------------------------------------------------------------------------
# Kernel bounds (bf16 operands, as the cells run them)
# ---------------------------------------------------------------------------
def flash_fwd_ms(bhq: int, bhkv: int, s: int, dh: int, with_lse: bool = False) -> float:
    """Causal flash forward: 4·Dh FLOP a live pair; q, k, v read and o
    written once in bf16, and where training keeps it the rows'
    log-sum-exp written in fp32."""
    flops = 4 * dh * bhq * causal_pairs(s)
    nbytes = 2 * dh * s * (2 * bhq + 2 * bhkv) + 4 * bhq * s * with_lse
    return least_ms(flops, nbytes)


def flash_bwd_ms(bhq: int, bhkv: int, s: int, dh: int) -> float:
    """Causal flash backward (D, dK/dV, dQ together): 10·Dh FLOP a live
    pair; q, k, v, o, dO (bf16) and the log-sum-exp (fp32) read once, dQ,
    dK, dV (bf16) written once."""
    flops = 10 * dh * bhq * causal_pairs(s)
    nbytes = 2 * dh * s * (4 * bhq + 4 * bhkv) + 4 * bhq * s
    return least_ms(flops, nbytes)


#: the chunk of the matrix form that the WKV6 operation count assumes
WKV_CHUNK = 32


def wkv6_fwd_ms(bh: int, s: int, n: int, state_in: bool) -> float:
    """WKV6 forward, bf16 r, k, v: r, k, v (bf16), log w (fp32) read and the
    output (fp32) written once, u read, the final state (fp32) written and,
    where one is passed, the initial state read. Operations: the chunked
    matrix form, 4·C·N + 4·N² a token and head."""
    elems = bh * s * n
    nbytes = elems * (3 * 2 + 4 + 4) + bh * n * 4 + (1 + state_in) * bh * n * n * 4
    flops = bh * s * (4 * WKV_CHUNK * n + 4 * n * n)
    return least_ms(flops, nbytes)


def wkv6_bwd_ms(bh: int, s: int, n: int) -> float:
    """WKV6 backward, bf16 r, k, v: r, k, v (bf16), log w and dO (fp32)
    read once, dr, dk, dv (bf16) and d log w (fp32) written once;
    operations three times the forward's."""
    elems = bh * s * n
    nbytes = elems * (3 * 2 + 4 + 4 + 3 * 2 + 4)
    flops = 3 * bh * s * (4 * WKV_CHUNK * n + 4 * n * n)
    return least_ms(flops, nbytes)
