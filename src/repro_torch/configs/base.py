"""Model / shape configuration dataclasses of the port.

A field-for-field copy of ``repro.configs.base`` (plain data, no framework):
every architecture is a ``ModelConfig``, and the port's models read only
from here. ``tests/test_torch_model.py`` holds every copy equal to the
reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (dense one-hot dispatch)."""

    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden width
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective-SSM head configuration (used by hybrid archs)."""

    state_size: int
    d_inner: int  # inner (expanded) width of the SSM branch
    dt_rank: int = 8


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) configuration: data-dependent decay token mixing."""

    head_size: int = 64
    decay_lora: int = 64  # low-rank width of the data-dependent decay projection
    tokenshift_lora: int = 32


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None  # defaults to d_model // n_heads
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: Optional[int] = None  # SWA window; None = full attention
    attn_chunk: int = 512  # kv-block size for chunked online-softmax attention
    # norms / mlp
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    mlp_gated: bool = True  # SwiGLU when True, plain act(W1 x) W2 when False
    mlp_act: str = "silu"  # silu | gelu
    linear_bias: bool = False  # bias on all dense layers (starcoder2/whisper style)
    tie_embeddings: bool = False
    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    attention_free: bool = False  # rwkv6: no attention at all
    hybrid_parallel_ssm: bool = False  # hymba: attention + SSM heads in parallel
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # audio frames after the (stubbed) conv frontend
    # modality frontend stubs
    frontend: Optional[str] = None  # audio | vision | None
    n_frontend_tokens: int = 0  # vision patch tokens prepended to the text sequence
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat_policy: str = "nothing"  # nothing | dots | full
    scan_unroll: bool = False  # unroll the layer scan (cost_analysis validation)
    source: str = ""  # provenance note ([arXiv/hf; tier])

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    # ------------------------------------------------------------------
    # Parameter counting (used for MODEL_FLOPS = 6 * N * D in the roofline)
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        d = self.d_model
        p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            p += self.q_dim + 2 * self.kv_dim
        if self.linear_bias:
            p += d
        return p

    def _mlp_params_dense(self) -> int:
        d, f = self.d_model, self.d_ff
        n_mats = 3 if self.mlp_gated else 2
        p = n_mats * d * f
        if self.linear_bias:
            p += (f + d) if not self.mlp_gated else (2 * f + d)
        return p

    def _moe_params(self, active: bool) -> int:
        assert self.moe is not None
        d, fe = self.d_model, self.moe.d_expert
        n_mats = 3 if self.mlp_gated else 2
        per_expert = n_mats * d * fe
        router = d * self.moe.n_experts
        n_used = self.moe.top_k if active else self.moe.n_experts
        return router + n_used * per_expert

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        d, di, s = self.d_model, self.ssm.d_inner, self.ssm.state_size
        # in_proj (x and z), dt/B/C projections, out_proj, A log, D
        return d * di * 2 + di * (self.ssm.dt_rank + 2 * s) + self.ssm.dt_rank * di + di * d + di * s + di

    def _rwkv_layer_params(self) -> int:
        assert self.rwkv is not None
        d = self.d_model
        lora_w = self.rwkv.decay_lora
        lora_x = self.rwkv.tokenshift_lora
        # time-mix: r,k,v,g,o projections + decay LoRA + tokenshift LoRAs + u (bonus)
        tm = 5 * d * d + (d * lora_w + lora_w * d) + 5 * (d * lora_x + lora_x * d) + d
        # channel-mix: Wk (d->f), Wv (f->d), Wr (d->d)
        cm = d * self.d_ff + self.d_ff * d + d * d
        return tm + cm

    def layer_params(self, active: bool = False) -> int:
        if self.attention_free:
            return self._rwkv_layer_params()
        p = self._attn_params()
        if self.hybrid_parallel_ssm:
            p += self._ssm_params()
        if self.moe is not None:
            p += self._moe_params(active=active)
        else:
            p += self._mlp_params_dense()
        # two (or three for hybrid) norm scales — negligible but counted
        p += 2 * self.d_model
        return p

    def n_params(self, active: bool = False, include_embeddings: bool = True) -> int:
        """Total (or activated, for MoE) parameter count."""
        n_dec = self.n_layers * self.layer_params(active=active)
        n_enc = 0
        if self.enc_dec:
            # encoder layers: self-attn + dense mlp; decoder layers additionally
            # carry cross-attention (same shape as self-attention).
            n_enc = self.n_encoder_layers * (self._attn_params() + self._mlp_params_dense() + 2 * self.d_model)
            n_dec += self.n_layers * self._attn_params()  # cross-attn in decoder
        emb = self.vocab_size * self.d_model
        unemb = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        if not include_embeddings:
            emb = 0
        return n_dec + n_enc + emb + unemb

    def matmul_params(self, active: bool = False) -> int:
        """Params that participate in per-token matmuls (for 6*N*D):
        excludes the input embedding gather, includes the unembedding."""
        n = self.n_params(active=active, include_embeddings=False)
        if self.tie_embeddings:
            n += self.vocab_size * self.d_model  # unembed matmul still happens
        return n


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# Archs able to run long_500k (sub-quadratic / bounded-state decode):
#   rwkv6 (attention-free O(1) state), hymba (SWA + SSM), mixtral (SWA cache).
# All others are pure full-attention — skipped per assignment, see DESIGN.md §4.
LONG_CONTEXT_CAPABLE = {"rwkv6-3b", "hymba-1.5b", "mixtral-8x22b"}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; returns (ok, reason_if_skipped)."""
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_CAPABLE:
        return False, "pure full-attention arch: 500k dense KV cache excluded by assignment"
    return True, ""


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test-sized config of the same family (small widths, few experts)."""
    kv_ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_heads = 4
    n_kv = max(1, n_heads // kv_ratio)
    changes: dict = dict(
        n_layers=2,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        encoder_seq=16,
        attn_chunk=32,
    )
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            n_experts=min(4, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k),
            d_expert=64,
        )
    if cfg.ssm is not None:
        changes["ssm"] = SSMConfig(state_size=8, d_inner=128, dt_rank=4)
    if cfg.rwkv is not None:
        changes["rwkv"] = RWKVConfig(head_size=16, decay_lora=8, tokenshift_lora=8)
    if cfg.enc_dec:
        changes["n_encoder_layers"] = 2
    if cfg.sliding_window is not None:
        changes["sliding_window"] = 32
    if cfg.n_frontend_tokens:
        changes["n_frontend_tokens"] = 8
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
