"""The port's selective SSM and the hybrid family (hymba-1.5b, reduced)
against ``repro``'s, on the CPU, in fp32.

Weights are the reference's (``init_model``), carried across with
``models.carry``; inputs come from numpy. The scan, the SSM branch and its
decode step, the model's logits, emitted caches (K/V ring and SSM state) and
16 decode steps agree to a relative error (max |diff| / max |value|) below
2e-4, the bound of ``tests/test_decode_equiv.py``: both packages run the
same first-order recurrence in fp32, summed in another order (an
associative scan there, a token loop here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import init_model as ref_init_model
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.models import carry, decode_step, forward, init_cache, init_model, ssm

CFG = configs.reduced(configs.get_config("hymba-1.5b"), dtype="float32")
REF_CFG = ref_configs.reduced(ref_configs.get_config("hymba-1.5b"), dtype="float32")
TOL = 2e-4


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tree():
    """The reference's reduced hymba weights, with dt_bias and the branch
    scales drawn from numpy (the schema starts them at zeros and ones), so
    that every path of the block carries its own weight."""
    t = to_np(ref_init_model(REF_CFG, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    layers = t["layers"]
    layers["ssm"]["dt_bias"] = rng.uniform(-2, 1, layers["ssm"]["dt_bias"].shape).astype(np.float32)
    layers["branch_scale"] = rng.uniform(0.5, 1.5, layers["branch_scale"].shape).astype(np.float32)
    return t


def ssm_params(tree):
    return {k: v[0] for k, v in tree["layers"]["ssm"].items()}


def torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


# ------------------------------------------------------------------ the SSM
def test_a_log_init_is_the_references():
    ours = init_model(CFG, 0, device="cpu")["layers"]["ssm"]["a_log"].numpy()
    theirs = to_np(ref_init_model(REF_CFG, jax.random.PRNGKey(0)))["layers"]["ssm"]["a_log"]
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() < 1e-6


@pytest.mark.parametrize("seq", [1, 63, 64, 100, 200])  # 64 divides two of them
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_scan_matches(tree, seq, with_state):
    p = ssm_params(tree)
    di, st = CFG.ssm.d_inner, CFG.ssm.state_size
    x = randn((2, seq, di), seed=seq)
    s0 = randn((2, di, st), seed=seq + 1) if with_state else np.zeros((2, di, st), np.float32)
    y, state = ssm.ssm_scan(torch_tree(p), torch.from_numpy(x), torch.from_numpy(s0), CFG)
    ry, rstate = ref_ssm.ssm_scan(p, jnp.asarray(x), jnp.asarray(s0), REF_CFG)
    assert y.shape == x.shape and state.shape == s0.shape
    assert rel_err(y, ry) < TOL
    assert rel_err(state, rstate) < TOL


def test_ssm_scan_in_two_calls_equals_one(tree):
    """The state carried out of one call continues the sequence in the next."""
    p = torch_tree(ssm_params(tree))
    x = torch.from_numpy(randn((2, 150, CFG.ssm.d_inner), seed=3))
    s0 = torch.zeros(2, CFG.ssm.d_inner, CFG.ssm.state_size)
    y, state = ssm.ssm_scan(p, x, s0, CFG)
    y1, mid = ssm.ssm_scan(p, x[:, :70], s0, CFG)
    y2, end = ssm.ssm_scan(p, x[:, 70:], mid, CFG)
    assert rel_err(torch.cat([y1, y2], 1), y) < 1e-5
    assert rel_err(end, state) < 1e-5


@pytest.mark.parametrize("seq", [37, 128])
def test_apply_ssm_matches(tree, seq):
    p = ssm_params(tree)
    x = randn((2, seq, CFG.d_model), seed=seq)
    s0 = np.zeros((2, CFG.ssm.d_inner, CFG.ssm.state_size), np.float32)
    y, state = ssm.apply_ssm(CFG, torch_tree(p), torch.from_numpy(x), torch.from_numpy(s0))
    ry, rstate = ref_ssm.apply_ssm(REF_CFG, p, jnp.asarray(x), jnp.asarray(s0))
    assert rel_err(y, ry) < TOL
    assert rel_err(state, rstate) < TOL


def test_apply_ssm_step_matches_and_continues_the_scan(tree):
    """Eight steps from a nonzero state against the reference's step, and
    against apply_ssm over the same eight tokens."""
    p = ssm_params(tree)
    x = randn((2, 8, CFG.d_model), seed=5)
    s0 = randn((2, CFG.ssm.d_inner, CFG.ssm.state_size), seed=6, scale=0.1)
    state, ref_state, ys = torch.from_numpy(s0), jnp.asarray(s0), []
    for t in range(8):
        y, state = ssm.apply_ssm_step(CFG, torch_tree(p), torch.from_numpy(x[:, t:t + 1]),
                                      state)
        ry, ref_state = ref_ssm.apply_ssm_step(REF_CFG, p, jnp.asarray(x[:, t:t + 1]),
                                               ref_state)
        assert rel_err(y, ry) < TOL
        ys.append(y)
    assert rel_err(state, ref_state) < TOL
    y_seq, s_seq = ssm.apply_ssm(CFG, torch_tree(p), torch.from_numpy(x), torch.from_numpy(s0))
    assert rel_err(torch.cat(ys, 1), y_seq) < TOL
    assert rel_err(state, s_seq) < TOL


# ------------------------------------------------------------------ the model
def port_params(tree):
    return carry.params_from_reference(CFG, tree, device="cpu")


@pytest.mark.parametrize("seq", [20, 100])  # inside the window of 32, and past it
def test_forward_logits_and_cache_match(tree, seq):
    toks = tokens(2, seq, seed=seq)
    want, want_cache, _ = ref_forward(REF_CFG, tree, {"tokens": jnp.asarray(toks)},
                                      emit_cache=True)
    got, got_cache = forward(CFG, port_params(tree), {"tokens": torch.from_numpy(toks)},
                             emit_cache=True)
    assert got.shape == (2, seq, CFG.vocab_size)
    assert rel_err(got, want) < TOL
    got_cache = carry.cache_to_arrays(got_cache)
    assert sorted(got_cache) == sorted(want_cache) == ["k", "slot_pos", "ssm", "v"]
    for name in ("k", "v", "ssm"):
        assert got_cache[name].shape == want_cache[name].shape
        assert rel_err(got_cache[name], want_cache[name]) < TOL
    assert np.array_equal(got_cache["slot_pos"], np.asarray(want_cache["slot_pos"]))


def test_decode_matches_reference_and_forward(tree):
    """16 decode steps against repro's decode_step and the port's forward
    over the same tokens; the final cache (K/V ring, SSM state)."""
    toks = tokens(2, 16, seed=7)
    step = jax.jit(lambda p, c, t, pos: ref_decode_step(REF_CFG, p, c, t, pos))
    ref_cache = ref_init_cache(REF_CFG, 2, 16)
    cache = init_cache(CFG, 2, 16, device="cpu")
    params = port_params(tree)
    want, got = [], []
    for t in range(16):
        lg, ref_cache = step(tree, ref_cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        want.append(np.asarray(lg[:, 0]))
        lg, cache = decode_step(CFG, params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        got.append(lg[:, 0].numpy())
    want, got = np.stack(want, 1), np.stack(got, 1)
    assert rel_err(got, want) < TOL
    full, pre = forward(CFG, params, {"tokens": torch.from_numpy(toks)}, emit_cache=True)
    assert rel_err(got, full) < TOL
    ours, ref_cache = carry.cache_to_arrays(cache), to_np(ref_cache)
    for name in ("k", "v", "ssm"):
        assert rel_err(ours[name], ref_cache[name]) < TOL
    assert rel_err(ours["ssm"], carry.cache_to_arrays(pre)["ssm"]) < TOL
    assert np.array_equal(ours["slot_pos"], ref_cache["slot_pos"])


def test_prefill_cache_hands_off_to_decode_past_the_window(tree):
    """A 40-token prefill (window 32: the ring has wrapped) carried from the
    reference into the port and back unchanged; 16 decode steps on from it
    against forward over all 56 tokens."""
    toks = tokens(1, 56, seed=8)
    _, ref_pre, _ = ref_forward(REF_CFG, tree, {"tokens": jnp.asarray(toks[:, :40])},
                                emit_cache=True)
    ref_pre = to_np(ref_pre)
    cache = carry.cache_from_reference(CFG, ref_pre, device="cpu")
    back = carry.cache_to_arrays(cache)
    assert sorted(back) == ["k", "slot_pos", "ssm", "v"]
    for name in ref_pre:
        assert np.array_equal(back[name], ref_pre[name])
    params = port_params(tree)
    got = []
    for t in range(40, 56):
        lg, cache = decode_step(CFG, params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        got.append(lg[:, 0])
    full, _ = forward(CFG, params, {"tokens": torch.from_numpy(toks)})
    assert rel_err(torch.stack(got, 1), full[:, 40:]) < TOL


def test_schema_and_cache_spec_follow_the_reference():
    """Hybrid blocks hold ssm/* and branch_scale; the cache an fp32 'ssm'
    leaf (L, B, d_inner, state) beside the K/V ring."""
    from repro.models import schema as ref_schema
    from repro.models import transformer as ref_transformer
    from repro_torch.models import schema, transformer

    ours = dict(schema.leaf_paths(transformer.block_schema(CFG)))
    theirs = dict(ref_schema._leaf_paths(ref_transformer.block_schema(REF_CFG)))
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}
    assert {k: v.init for k, v in ours.items()} == {k: v.init for k, v in theirs.items()}
    spec = transformer.cache_spec(CFG, 3, 50)
    assert spec["ssm"] == ((CFG.n_layers, 3, CFG.ssm.d_inner, CFG.ssm.state_size),
                           torch.float32)
    assert spec["k"][0][2] == CFG.sliding_window
    ref_spec = ref_transformer.cache_spec(REF_CFG, 3, 50)
    assert {k: v[0] for k, v in spec.items()} == {k: v[0] for k, v in ref_spec.items()}
