"""The port's WKV6 plain forms and RWKV6 block against ``repro``'s, on the CPU.

Inputs come from numpy (``np.random.default_rng``) and go to both packages.
Tolerances are the reference's own (``tests/test_kernels_rwkv6.py``): 5e-4
relative (max |diff| / max |value|) against the exact sequential scan, 3e-2
for bf16 inputs, and 1e-4 absolute against the chunked form
``repro.models.rwkv6.wkv_chunked``. The block tests run the reduced rwkv6-3b
in fp32 to a relative error below 2e-4 (``tests/test_decode_equiv.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels.rwkv6.ops import wkv6 as ref_wkv6_pallas
from repro.kernels.rwkv6.ref import wkv6_ref as ref_wkv6_ref
from repro.models import rwkv6 as ref_rwkv6
from repro_torch import configs
from repro_torch.kernels.rwkv6 import kernel as K
from repro_torch.kernels.rwkv6 import ops, ref
from repro_torch.models import rwkv6

# (b, s, h, n, omega_hi, chunk, dtype): tests/test_kernels_rwkv6.py's CASES
CASES = [
    (2, 64, 4, 64, 0.5, 32, "float32"),
    (1, 128, 2, 64, 1.0, 32, "float32"),
    (1, 96, 2, 64, 0.5, 16, "float32"),  # chunk invariance
    (2, 96, 3, 32, 0.5, 32, "bfloat16"),
    (1, 64, 1, 128, 0.0, 32, "float32"),  # aggressive decay
]
CFG = configs.reduced(configs.get_config("rwkv6-3b"), dtype="float32")
REF_CFG = ref_configs.reduced(ref_configs.get_config("rwkv6-3b"), dtype="float32")


def case_id(c):
    return f"b{c[0]}s{c[1]}h{c[2]}n{c[3]}c{c[5]}{c[6]}"


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def inputs(b, s, h, n, omega_hi, seed=0, omega=None):
    """r, k, v, logw (B, S, H, N) and u (H, N), fp32 numpy. ``omega``
    (broadcast to the inputs) replaces the uniform [-6, omega_hi] draw."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n), np.float32) for _ in range(3))
    if omega is None:
        omega = rng.uniform(-6.0, omega_hi, (b, s, h, n))
    logw = (-np.exp(omega)).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.3).astype(np.float32)
    return r, k, v, logw, u


def both(arrays, dtype):
    """The same values in both frameworks: jax arrays and torch tensors,
    rounded to ``dtype`` alike (bf16 round-to-nearest-even in each)."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def ref_sequential(r, k, v, logw, u):
    """repro's exact scan on the (B, S, H, N) layout, as its test's _ref."""
    b, s, h, n = r.shape
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(b * h, s, n)  # noqa: E731
    ue = jnp.broadcast_to(u[None], (b, h, n)).reshape(b * h, n)
    out = ref_wkv6_ref(fold(r), fold(k), fold(v), fold(logw), ue)
    return np.asarray(out.reshape(b, h, s, n).transpose(0, 2, 1, 3).astype(jnp.float32))


def tol(dtype):
    return 3e-2 if dtype == "bfloat16" else 5e-4


# ------------------------------------------------------- the plain forms
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_entry_point_matches_the_sequential_scan(case):
    """ops.wkv6 on CPU tensors (the plain chunked form) against repro's
    wkv6_ref, from a zero state."""
    b, s, h, n, ohi, _, dt = case
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = both(inputs(b, s, h, n, ohi), dt)
    want = ref_sequential(jr, jk, jv, jw, ju)
    got, st = ops.wkv6(tr, tk, tv, tw, tu)
    assert got.dtype == torch.float32 and st.shape == (b, h, n, n)
    assert rel_err(got, want) < tol(dt)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_sequential_scan_matches_the_reference(case):
    b, s, h, n, ohi, _, dt = case
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = both(inputs(b, s, h, n, ohi, seed=1), dt)
    want = ref_sequential(jr, jk, jv, jw, ju)
    ue = tu[None].expand(b, h, n).reshape(b * h, n)
    got, _ = ref.wkv6_ref(*map(ref.fold_heads, (tr, tk, tv, tw)), ue)
    assert rel_err(ref.unfold_heads(got, b), want) < tol(dt)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_chunked_form_carries_the_state_as_the_reference(case):
    """The port's wkv_chunked against repro's, from the same nonzero state,
    at the case's chunk; outputs and final state to 1e-4."""
    b, s, h, n, ohi, chunk, dt = case
    arrays = inputs(b, s, h, n, ohi, seed=2)
    s0 = (np.random.default_rng(3).standard_normal((b, h, n, n)) * 0.1).astype(np.float32)
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = both(arrays, dt)
    want, want_st = ref_rwkv6.wkv_chunked(jr, jk, jv, jw, ju, jnp.asarray(s0), chunk=chunk)
    got, got_st = rwkv6.wkv_chunked(tr, tk, tv, tw, tu, torch.from_numpy(s0), chunk=chunk)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-4
    assert np.abs(got_st.numpy() - np.asarray(want_st)).max() < 1e-4


@pytest.mark.parametrize("seq", [77, 33, 5])
def test_ragged_length_matches_the_reference(seq):
    """S no multiple of 32: repro's wkv_chunked pads with logw = 0; the
    port's entry point must give its outputs and its final state."""
    b, h, n = 2, 2, 32
    arrays = inputs(b, seq, h, n, 0.5, seed=seq)
    s0 = (np.random.default_rng(seq + 1).standard_normal((b, h, n, n)) * 0.1).astype(np.float32)
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = both(arrays, "float32")
    want, want_st = ref_rwkv6.wkv_chunked(jr, jk, jv, jw, ju, jnp.asarray(s0))
    got, got_st = ops.wkv6(tr, tk, tv, tw, tu, torch.from_numpy(s0))
    assert got.shape == (b, seq, h, n)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-4
    assert np.abs(got_st.numpy() - np.asarray(want_st)).max() < 1e-4
    from_zero, _ = ops.wkv6(tr, tk, tv, tw, tu)
    assert rel_err(from_zero, ref_sequential(jr, jk, jv, jw, ju)) < 5e-4


def test_state_carry_across_calls():
    """One call over 128 tokens equals two calls of 64 with the state
    carried, and both equal repro's chunked form carried the same way."""
    b, s, h, n = 1, 128, 2, 64
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = both(inputs(b, s, h, n, 0.5, seed=9),
                                                     "float32")
    full, full_st = ops.wkv6(tr, tk, tv, tw, tu)
    o1, st = ops.wkv6(tr[:, :64], tk[:, :64], tv[:, :64], tw[:, :64], tu)
    o2, st = ops.wkv6(tr[:, 64:], tk[:, 64:], tv[:, 64:], tw[:, 64:], tu, st)
    assert (torch.cat([o1, o2], 1) - full).abs().max() < 5e-4
    assert (st - full_st).abs().max() < 5e-4
    ref_st = jnp.zeros((b, h, n, n), jnp.float32)
    w1, ref_st = ref_rwkv6.wkv_chunked(jr[:, :64], jk[:, :64], jv[:, :64], jw[:, :64], ju, ref_st)
    w2, ref_st = ref_rwkv6.wkv_chunked(jr[:, 64:], jk[:, 64:], jv[:, 64:], jw[:, 64:], ju, ref_st)
    assert np.abs(full.numpy() - np.concatenate([w1, w2], 1)).max() < 1e-4
    assert np.abs(full_st.numpy() - np.asarray(ref_st)).max() < 1e-4


def decay_base_omega(n, seed, b=1, s=64, h=2):
    """rwkv6's decay_base spread (-6 + 7 linspace(0, 1)^1.5) over a head's
    channels, plus 0.1 noise per element."""
    base = -6.0 + 7.0 * np.linspace(0.0, 1.0, n) ** 1.5
    return base + 0.1 * np.random.default_rng(seed).standard_normal((b, s, h, n))


def test_decay_base_spread_is_exact_where_the_pallas_clamp_is_not():
    """The channels of rwkv6's own decay_base init that decay by more than
    e^-30 within a 32-token chunk: the port's plain form holds 5e-4 of the
    exact scan, repro's Pallas kernel (interpret mode, cum >= -30 clamp)
    does not."""
    b, s, h, n = 1, 64, 2, 64
    arrays = inputs(b, s, h, n, None, seed=4, omega=decay_base_omega(n, 5))
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = both(arrays, "float32")
    want = ref_sequential(jr, jk, jv, jw, ju)
    got, _ = ops.wkv6(tr, tk, tv, tw, tu)
    assert rel_err(got, want) < 5e-4
    chunked, _ = ref_rwkv6.wkv_chunked(jr, jk, jv, jw, ju, jnp.zeros((b, h, n, n)))
    assert rel_err(chunked, want) < 5e-4
    pallas = ref_wkv6_pallas(jr, jk, jv, jw, ju)
    assert rel_err(pallas, want) > 1e-2  # the clamp's error, ~1e-1


def test_cpu_tensors_take_the_plain_form_and_launch_nothing():
    K.reset_launches()
    (_, (tr, tk, tv, tw, tu)) = both(inputs(1, 40, 2, 16, 0.5, seed=6), "float32")
    out, st = K.wkv6_bhsn(*map(ref.fold_heads, (tr, tk, tv, tw)), tu)
    want, want_st = ref.wkv_chunked_bhsn(*map(ref.fold_heads, (tr, tk, tv, tw)), tu)
    assert torch.equal(out, want) and torch.equal(st, want_st)
    assert K.wkv6_bhsn.launches == 0


# ---------------------------------------------------------------- the block
def block_params(seed=0):
    """Every leaf of the reduced rwkv block drawn from numpy (mu and u too,
    which the schema starts at zero), w0 from the decay_base spread."""
    rng = np.random.default_rng(seed)
    out = {}
    for part, leaves in rwkv6.rwkv_schema(CFG).items():
        out[part] = {name: (rng.standard_normal(p.shape) * (0.3 if name in ("mu", "u")
                                                            else 1 / np.sqrt(p.shape[0])))
                     .astype(np.float32) for name, p in leaves.items()}
    d = CFG.d_model
    out["tm"]["w0"] = (-6.0 + 7.0 * np.linspace(0, 1, d) ** 1.5).astype(np.float32)
    out["tm"]["mu"] = rng.uniform(0, 1, (5, d)).astype(np.float32)
    out["cm"]["mu"] = rng.uniform(0, 1, (2, d)).astype(np.float32)
    return out


def torch_tree(tree):
    return {k: torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("seq", [12, 40])
def test_time_mix_matches_the_reference(seq):
    p = block_params(1)
    rng = np.random.default_rng(seq)
    b, d = 2, CFG.d_model
    h, n = d // CFG.rwkv.head_size, CFG.rwkv.head_size
    x = rng.standard_normal((b, seq, d)).astype(np.float32)
    prev = rng.standard_normal((b, d)).astype(np.float32)
    st = (rng.standard_normal((b, h, n, n)) * 0.1).astype(np.float32)
    want = ref_rwkv6.apply_time_mix(REF_CFG, p["tm"], *map(jnp.asarray, (x, prev, st)))
    got = rwkv6.apply_time_mix(CFG, torch_tree(p)["tm"], *map(torch.from_numpy, (x, prev, st)))
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel_err(g, w) < 2e-4


def test_channel_mix_matches_the_reference():
    p = block_params(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, CFG.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, CFG.d_model)).astype(np.float32)
    want = ref_rwkv6.apply_channel_mix(REF_CFG, p["cm"], jnp.asarray(x), jnp.asarray(prev))
    got = rwkv6.apply_channel_mix(CFG, torch_tree(p)["cm"], torch.from_numpy(x),
                                  torch.from_numpy(prev))
    for g, w in zip(got, want):
        assert rel_err(g, w) < 2e-4


def test_step_forms_match_the_reference():
    """apply_time_mix_step, apply_channel_mix_step and wkv_step, one token."""
    p = block_params(3)
    rng = np.random.default_rng(4)
    b, d = 3, CFG.d_model
    h, n = d // CFG.rwkv.head_size, CFG.rwkv.head_size
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    prev = rng.standard_normal((b, d)).astype(np.float32)
    st = (rng.standard_normal((b, h, n, n)) * 0.1).astype(np.float32)
    want = ref_rwkv6.apply_time_mix_step(REF_CFG, p["tm"], *map(jnp.asarray, (x, prev, st)))
    got = rwkv6.apply_time_mix_step(CFG, torch_tree(p)["tm"],
                                    *map(torch.from_numpy, (x, prev, st)))
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel_err(g, w) < 2e-4
    want = ref_rwkv6.apply_channel_mix_step(REF_CFG, p["cm"], jnp.asarray(x), jnp.asarray(prev))
    got = rwkv6.apply_channel_mix_step(CFG, torch_tree(p)["cm"], torch.from_numpy(x),
                                       torch.from_numpy(prev))
    for g, w in zip(got, want):
        assert rel_err(g, w) < 2e-4


def test_sequence_form_equals_the_step_form_token_by_token():
    """apply_time_mix over 40 tokens (through ops.wkv6) equals 40 calls of
    apply_time_mix_step (through wkv_step), state and all."""
    p = torch_tree(block_params(4))["tm"]
    rng = np.random.default_rng(5)
    b, d = 2, CFG.d_model
    h, n = d // CFG.rwkv.head_size, CFG.rwkv.head_size
    x = torch.from_numpy(rng.standard_normal((b, 40, d)).astype(np.float32))
    prev = torch.zeros(b, d)
    st = torch.zeros(b, h, n, n)
    y, last, st_seq = rwkv6.apply_time_mix(CFG, p, x, prev, st)
    ys = []
    for t in range(40):
        yt, prev, st = rwkv6.apply_time_mix_step(CFG, p, x[:, t:t + 1], prev, st)
        ys.append(yt)
    assert rel_err(torch.cat(ys, 1), y) < 2e-4
    assert rel_err(st, st_seq) < 2e-4 and torch.equal(prev, last)
