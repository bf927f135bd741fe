"""Analytic roofline model per (arch, shape, mesh), at H100 rates (the port
of ``repro.analysis.roofline``).

Why analytic: a step's FLOPs, bytes and collective bytes follow from the
configs (every matmul in the model is enumerated below), on any mesh,
with no device of that size at hand. The arithmetic is the reference's,
leaf for leaf; only the rates differ. ``tests/test_torch_roofline.py``
holds every rate-free quantity float-equal to the reference's and the
forward FLOPs within 25 % of ``analysis.costs``' count of the model's own
step (``FlopCounterMode``).

Terms (per training/serving step):
  compute    = total_FLOPs / (chips * peak_FLOP/s)
  memory     = per_device_HBM_bytes / HBM_bw
  collective = per_device_collective_bytes / link_bw

Hardware: one NVIDIA H100 SXM a rank (NVIDIA's data sheet, dense rates, at
its 700 W limit): 989 TFLOP/s bf16, 3.35 TB/s HBM3, NVLink 4 at 900 GB/s
per GPU both ways together, 450 GB/s each way (the rate one rank sends at).
The int32 issue rate of the lease kernels is ``chip_smoke.py``'s SASS
bound's: 64 ALU lanes a SM a clock, 132 SMs, 1.98 GHz.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
HBM_BW = 3.35e12
LINK_BW = 450e9  # NVLink 4, one direction
INT32_OPS_PER_S = 64 * 132 * 1.98e9  # ALU lanes x SMs x boost clock

MOE_GROUP = 512  # must match models.moe.moe_dispatch default


@dataclass
class MeshShape:
    pod: int
    data: int
    model: int

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    @property
    def dp(self) -> int:
        return self.pod * self.data


MESHES = {"pod16x16": MeshShape(1, 16, 16), "pod2x16x16": MeshShape(2, 16, 16)}


# ---------------------------------------------------------------------------
# FLOPs (totals across all chips, forward pass; train multiplies below)
# ---------------------------------------------------------------------------
def _attn_flops_fwd(cfg: ModelConfig, batch: int, s_q: int, s_kv_eff: float) -> float:
    """QK^T + PV matmuls, all layers."""
    per_layer = 2 * 2 * batch * cfg.n_heads * cfg.head_dim * s_q * s_kv_eff
    return per_layer * cfg.n_layers


def _rwkv_mix_flops_fwd(cfg: ModelConfig, tokens: float, chunk: int = 32) -> float:
    h = cfg.d_model // cfg.rwkv.head_size
    n = cfg.rwkv.head_size
    per_tok_head = 4 * chunk * n + 4 * n * n  # intra matmuls + state/inter
    return per_tok_head * h * cfg.n_layers * tokens


def _ssm_flops_fwd(cfg: ModelConfig, tokens: float) -> float:
    di, st = cfg.ssm.d_inner, cfg.ssm.state_size
    return 8.0 * di * st * tokens * cfg.n_layers  # elementwise scan + C/B contractions


def _moe_dispatch_flops_fwd(cfg: ModelConfig, tokens: float, group: int = MOE_GROUP) -> float:
    """Dispatch + combine one-hot einsums: each costs 2*T*(E*C)*d with
    E*C ~= group*top_k*capacity per group — LINEAR in the group size."""
    moe = cfg.moe
    slots = group * moe.top_k * moe.capacity_factor  # ~ E*C per group
    return 4.0 * tokens * slots * cfg.d_model * cfg.n_layers


def flops_fwd(cfg: ModelConfig, shape: ShapeConfig, variant: dict | None = None) -> float:
    """Forward FLOPs of one step, totals across chips.

    variant flags (all default off = the naive baseline implementation):
      swa_block_skip — sliding-window block skipping (the flash kernels
        skip the tiles outside the window; a plain path computes them)
      logits_last    — prefill unembeds only the final position
    """
    variant = variant or {}
    b = shape.global_batch
    if shape.kind == "decode":
        toks = float(b)
        mm = 2.0 * cfg.matmul_params(active=True) * toks
        if cfg.attention_free:
            h = cfg.d_model // cfg.rwkv.head_size
            n = cfg.rwkv.head_size
            mix = 4.0 * n * n * h * cfg.n_layers * toks
            return mm + mix
        s_cache = min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window else shape.seq_len
        attn = _attn_flops_fwd(cfg, b, 1, s_cache)
        if cfg.hybrid_parallel_ssm:
            attn += _ssm_flops_fwd(cfg, toks)
        if cfg.enc_dec:
            attn += 2 * 2 * b * cfg.n_heads * cfg.head_dim * 1 * cfg.encoder_seq * cfg.n_layers
        return mm + attn

    toks = float(b * shape.seq_len)
    mm = 2.0 * cfg.matmul_params(active=True) * toks
    extra = 0.0
    if cfg.attention_free:
        extra += _rwkv_mix_flops_fwd(cfg, toks)
    else:
        s_kv = shape.seq_len / 2.0  # causal average
        if cfg.sliding_window and variant.get("swa_block_skip"):
            # a plain path computes (masked) full blocks; only the flash
            # kernels' tile skip realizes the SWA saving
            s_kv = min(s_kv, float(cfg.sliding_window))
        extra += _attn_flops_fwd(cfg, b, shape.seq_len, s_kv)
        if cfg.hybrid_parallel_ssm:
            extra += _ssm_flops_fwd(cfg, toks)
        if cfg.enc_dec:
            # encoder self-attn (full 1500^2) + decoder cross-attn (S x 1500)
            e = cfg.encoder_seq
            extra += 2 * 2 * b * cfg.n_heads * cfg.head_dim * e * e * cfg.n_encoder_layers
            extra += 2 * 2 * b * cfg.n_heads * cfg.head_dim * shape.seq_len * e * cfg.n_layers
            # encoder matmul params are in matmul_params already
    if cfg.moe is not None:
        extra += _moe_dispatch_flops_fwd(cfg, toks)
    if variant.get("logits_last") and shape.kind == "prefill":
        # unembedding shrinks from T tokens to B tokens
        extra -= 2.0 * cfg.vocab_size * cfg.d_model * (toks - b)
    return mm + extra


_TRAIN_MULT = {"nothing": 3.0, "dots": 10.0 / 3.0, "full": 4.0}


def flops_step(cfg: ModelConfig, shape: ShapeConfig, variant: dict | None = None) -> float:
    variant = variant or {}
    f = flops_fwd(cfg, shape, variant)
    if shape.kind == "train":
        policy = variant.get("remat", cfg.remat_policy)
        return f * _TRAIN_MULT.get(policy, 3.0)
    return f


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The 6*N*D (or 6*N_active*D) yardstick the assignment asks for."""
    n = cfg.matmul_params(active=True)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * shape.tokens_per_step


# ---------------------------------------------------------------------------
# Per-device HBM bytes
# ---------------------------------------------------------------------------
def _param_bytes_per_device(cfg: ModelConfig, mesh: MeshShape, *, active_only: bool) -> float:
    n = cfg.n_params(active=active_only)
    # experts shard over dp when divisible; everything else over model only
    if cfg.moe is not None and not active_only:
        moe_p = cfg.n_layers * cfg._moe_params(active=False)
        rest = n - moe_p
        ep = mesh.dp if cfg.moe.n_experts % mesh.dp == 0 else 1
        return moe_p / (ep * mesh.model) + rest / mesh.model
    return n / mesh.model


def hbm_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshShape,
                         variant: dict | None = None) -> float:
    variant = variant or {}
    pbytes = 2 if variant.get("param_dtype") == "bfloat16" else 4
    if shape.kind == "decode":
        p = _param_bytes_per_device(cfg, mesh, active_only=False) * 2  # bf16 read
        cache = _cache_bytes_total(cfg, shape) / mesh.chips * 2  # read + write
        return p + cache
    toks_loc = shape.tokens_per_step / mesh.dp
    policy = variant.get("remat", cfg.remat_policy)
    act_tensors = {"nothing": 16, "dots": 10, "full": 6}.get(policy, 12)
    act = toks_loc * cfg.d_model * cfg.n_layers * act_tensors * 2 * 2  # r+w, bf16
    p_loc = _param_bytes_per_device(cfg, mesh, active_only=False)
    if shape.kind == "prefill":
        return p_loc * 2 + act / 2 + _cache_bytes_total(cfg, shape) / mesh.chips
    # train: bf16 fwd+bwd reads + grad w + adam m,v r/w + master param r/w
    opt_div = mesh.dp if variant.get("zero1") else 1
    param_traffic = p_loc * (2 * 3 + pbytes) + p_loc * (16 + 8) / opt_div
    return param_traffic + act


def _cache_bytes_total(cfg: ModelConfig, shape: ShapeConfig) -> float:
    b = shape.global_batch
    if cfg.attention_free:
        h = cfg.d_model // cfg.rwkv.head_size
        n = cfg.rwkv.head_size
        return cfg.n_layers * b * (h * n * n * 4 + 2 * cfg.d_model * 2)
    sc = min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window else shape.seq_len
    kv = cfg.n_layers * b * sc * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    if cfg.hybrid_parallel_ssm:
        kv += cfg.n_layers * b * cfg.ssm.d_inner * cfg.ssm.state_size * 4
    if cfg.enc_dec:
        kv += cfg.n_layers * b * cfg.encoder_seq * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    return kv


# ---------------------------------------------------------------------------
# Per-device collective bytes
# ---------------------------------------------------------------------------
def _collective_terms(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshShape,
                      variant: dict | None, grad_dtype_bytes: int | None) -> tuple:
    """(model-axis all-reduces, expert-parallel all-to-all, data-parallel
    gradient all-reduce) bytes per device, each as the reference sums it."""
    variant = variant or {}
    if grad_dtype_bytes is None:
        grad_dtype_bytes = 2 if variant.get("param_dtype") == "bfloat16" else 4
    d = cfg.d_model
    if shape.kind == "decode":
        b_loc = max(shape.global_batch // mesh.dp, 1)
        per_layer = 2 * 2 * b_loc * 1 * d * 2  # 2 TP all-reduces, ring 2x, bf16
        return per_layer * cfg.n_layers, 0.0, None
    toks_loc = shape.tokens_per_step / mesh.dp
    tp = 2 * 2 * toks_loc * d * 2 * cfg.n_layers  # fwd; bwd doubles it
    if shape.kind != "train":
        return tp, 0.0, None
    tp *= 2
    n_rep = cfg.n_params(active=False)
    a2a = 0.0
    if cfg.moe is not None and cfg.moe.n_experts % mesh.dp == 0:
        n_rep -= cfg.n_layers * cfg._moe_params(active=False)  # EP: no DP grad sync
        # EP all-to-all: tokens*topk*cf*d each way, fwd+bwd
        a2a = 2 * 2 * toks_loc * cfg.moe.top_k * cfg.moe.capacity_factor * d * 2 * cfg.n_layers
    return tp, a2a, 2 * (n_rep / mesh.model) * grad_dtype_bytes


def collective_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshShape,
                                variant: dict | None = None, *,
                                grad_dtype_bytes: int | None = None) -> float:
    tp, a2a, dp_grad = _collective_terms(cfg, shape, mesh, variant, grad_dtype_bytes)
    if dp_grad is None:
        return tp
    if a2a:
        tp += a2a
    return tp + dp_grad


def collective_bytes_by_op(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshShape,
                           variant: dict | None = None) -> dict:
    """``collective_bytes_per_device`` by the collectives reader's op names:
    the all-reduces (model axis, and the data-parallel gradient in a train
    step) and the expert-parallel all-to-all."""
    tp, a2a, dp_grad = _collective_terms(cfg, shape, mesh, variant, None)
    out = {"all-reduce": tp + (dp_grad or 0.0)}
    if a2a:
        out["all-to-all"] = a2a
    return out


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------
def roofline_terms(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshShape,
                   variant: dict | None = None,
                   coll_bytes_parsed: float | None = None) -> dict:
    """``coll_bytes_parsed``, when given (the collectives reader's per-device
    bytes of a traced step, ``analysis.hlo.parse_collectives``), overrides
    the analytic estimate: what the run's collectives moved, where the
    analytic formula documents the Megatron-style expectation."""
    f = flops_step(cfg, shape, variant)
    hbm = hbm_bytes_per_device(cfg, shape, mesh, variant)
    coll = coll_bytes_parsed if coll_bytes_parsed is not None else \
        collective_bytes_per_device(cfg, shape, mesh, variant)
    t_c = f / (mesh.chips * PEAK_FLOPS)
    t_m = hbm / HBM_BW
    t_x = coll / LINK_BW
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    bound = max(t_c, t_m, t_x)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "flops_total": f,
        "model_flops": mf,
        "useful_flops_frac": mf / f if f else 0.0,
        "hbm_bytes_per_dev": hbm,
        "coll_bytes_per_dev": coll,
        "step_time_bound_s": bound,
        "roofline_frac": (mf / (mesh.chips * PEAK_FLOPS)) / bound if bound else 0.0,
    }


# ---------------------------------------------------------------------------
# Lease plane (PaxosLease array engine)
# ---------------------------------------------------------------------------
def lease_plane_roofline(
    n_cells: int,
    n_acceptors: int = 5,
    n_proposers: int = 8,
    *,
    delayed: bool = True,
    window: int = 16,
) -> dict:
    """Analytic roofline of the lease window kernel per tick on one H100
    (the reference's byte model; its compute term at the int32 issue rate).

    The kernel is pure int32 work on the CUDA cores — no tensor core — so
    the interesting bound is memory. Two regimes:

      - ``resident``: the per-tick HBM traffic of the time-resident window
        kernel — only the streamed scenario planes move (attempt/release
        rows and the per-tick owner/count outputs; acc_up and the [P, A]
        link matrices are O(1) per tick), ~16 bytes/cell-tick. State never
        leaves registers inside a launch.
      - ``per_tick_dispatch``: the same tick if every state plane
        round-trips HBM (one dispatch a tick): all packed lease (+ netplane)
        planes in AND out each tick.

    ``smem_bytes_at_window`` is a block's dynamic shared memory, from the
    entry's ``kernel.LaunchPlan`` at this geometry (a ``window``-tick
    window, independent of ``n_cells``).
    """
    from ..lease_array.kernel import delayed_launch_plan, sync_launch_plan

    b = 4  # int32
    a = n_acceptors
    # packed planes: lease = 2x[A,N] + 2x[1,N]; netplane = 6x[A,N] + 6x[1,N]
    state_planes = (2 * a + 2) + ((6 * a + 6) if delayed else 0)
    streamed = 2 + 2  # attempt+release rows in, owner+count rows out
    # cell-independent per-tick streams: acc_up [A], the local-clock
    # columns pclk [P] / aclk [A], and the fused [P, A] link matrix
    # (delayed model only) — O(1) in N but P-proportional
    bcast_bytes = b * (
        a + n_proposers + a + (n_proposers * a if delayed else 0)
    )
    resident_bytes = streamed * b * n_cells + bcast_bytes
    dispatch_bytes = (2 * state_planes + streamed) * b * n_cells + bcast_bytes
    # int32 work: ~110 [A, N]-sized int ops per delayed tick (~25 sync)
    ops = (110 if delayed else 25) * a * n_cells
    t_resident = resident_bytes / HBM_BW
    t_dispatch = dispatch_bytes / HBM_BW
    t_compute = ops / INT32_OPS_PER_S
    plan_fn = delayed_launch_plan if delayed else sync_launch_plan
    plan = plan_fn(a, n_cells, n_proposers, window, window=window)
    return {
        "resident_hbm_bytes_per_tick": resident_bytes,
        "dispatch_hbm_bytes_per_tick": dispatch_bytes,
        "hbm_traffic_ratio": dispatch_bytes / resident_bytes,
        "compute_s_per_tick": t_compute,
        "memory_s_per_tick_resident": t_resident,
        "memory_s_per_tick_dispatch": t_dispatch,
        "bound": "compute" if t_compute > t_resident else "memory",
        "smem_bytes_at_window": plan.smem_bytes,
        "cell_ticks_per_s_bound": n_cells / max(t_compute, t_resident),
    }
