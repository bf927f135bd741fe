"""The port's language models (the dense family and rwkv6; the MoE and
hybrid families in ``test_torch_moe.py`` and ``test_torch_hybrid.py``, the
encoder-decoder in ``test_torch_enc_dec.py``, the vision frontend in
``test_torch_frontends.py``) against ``repro``'s, on the CPU; every
family's schema here.

Weights are made by the reference's ``init_model`` and carried across with
``models.carry.params_from_reference``; tokens come from numpy. Everything
runs in fp32, where the two frameworks differ only in summation order:
layers to abs 1e-6, logits and caches to a relative error (max |diff| /
max |value|) below 2e-4, the bound of ``tests/test_decode_equiv.py``.
"""
import dataclasses

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
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import schema as ref_schema
from repro.models import transformer as ref_transformer
from repro_torch import configs
from repro_torch.models import attention, carry, layers, schema, transformer
from repro_torch.models import decode_step, forward, init_cache, init_model

CFG = configs.reduced(configs.get_config("internlm2-1.8b"), dtype="float32")
REF_CFG = ref_configs.reduced(ref_configs.get_config("internlm2-1.8b"), dtype="float32")
SWA = dataclasses.replace(CFG, sliding_window=8)
REF_SWA = dataclasses.replace(REF_CFG, sliding_window=8)
PORTED = sorted(configs.REGISTRY)  # every family is ported
RWKV = configs.reduced(configs.get_config("rwkv6-3b"), dtype="float32")
REF_RWKV = ref_configs.reduced(ref_configs.get_config("rwkv6-3b"), dtype="float32")


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_params():
    return to_np(ref_init_model(REF_CFG, jax.random.PRNGKey(0)))


def port_params(cfg, tree):
    return carry.params_from_reference(cfg, tree, device="cpu")


def tokens(b, s, seed=0, vocab=CFG.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", sorted(configs.REGISTRY))
def test_configs_are_the_references(name):
    ours, theirs = configs.get_config(name), ref_configs.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(configs.reduced(ours)) == dataclasses.asdict(
        ref_configs.reduced(theirs))
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}


@pytest.mark.parametrize("name", PORTED)
def test_dense_schemas_count_the_references_parameters(name):
    cfg = configs.get_config(name)
    ours = dict(schema.leaf_paths(transformer.model_schema(cfg)))
    theirs = dict(ref_schema._leaf_paths(
        ref_transformer.model_schema(ref_configs.get_config(name))))
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}
    assert schema.count_params(transformer.model_schema(cfg)) == ref_schema.count_params(
        ref_transformer.model_schema(ref_configs.get_config(name)))


def test_init_model_is_seeded_and_on_the_card_by_default():
    a, b = init_model(CFG, 3, device="cpu"), init_model(CFG, 3, device="cpu")
    c = init_model(CFG, 4, device="cpu")
    wq = ("layers", "attn", "wq")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"], c["layers"]["attn"]["wq"])
    assert a["layers"]["attn"]["wq"].shape == dict(
        schema.leaf_paths(transformer.model_schema(CFG)))[wq].shape
    assert torch.equal(a["final_norm"]["scale"], torch.ones(CFG.d_model))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_model(CFG, 0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_cache(CFG, 1, 8)


# ------------------------------------------------------------------ layers
LAYER_CFGS = {
    "rmsnorm-swiglu": CFG,
    "layernorm-gelu-bias": dataclasses.replace(
        CFG, norm_type="layernorm", mlp_gated=False, mlp_act="gelu", linear_bias=True),
}


@pytest.mark.parametrize("kind", sorted(LAYER_CFGS))
def test_norm_and_mlp_match(kind):
    cfg = LAYER_CFGS[kind]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, cfg.d_model), np.float32)
    norm = {k: rng.standard_normal(p.shape, np.float32)
            for k, p in layers.norm_schema(cfg).items()}
    mlp = {k: rng.standard_normal(p.shape, np.float32) * 0.1
           for k, p in layers.mlp_schema(cfg).items()}
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731
    got = layers.apply_norm(cfg, t(norm), torch.from_numpy(x)).numpy()
    want = np.asarray(ref_layers.apply_norm(cfg, norm, jnp.asarray(x)))
    assert np.abs(got - want).max() < 1e-6
    got = layers.apply_mlp(cfg, t(mlp), torch.from_numpy(x)).numpy()
    want = np.asarray(ref_layers.apply_mlp(cfg, mlp, jnp.asarray(x)))
    assert np.abs(got - want).max() < 1e-6


@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches(batched):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 4, CFG.head_dim), np.float32)
    pos = (rng.integers(0, 300, (2, 9)) if batched else np.arange(9) + 40).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            layers.rope_freqs(CFG)).numpy()
    want = np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                            ref_layers.rope_freqs(CFG)))
    assert np.abs(got - want).max() < 1e-6
    assert np.abs(layers.rope_freqs(CFG).numpy()
                  - np.asarray(ref_layers.rope_freqs(CFG))).max() < 1e-6


def test_sinusoidal_positions_match():
    got = layers.sinusoidal_positions(12, 64, offset=5).numpy()
    want = np.asarray(ref_layers.sinusoidal_positions(12, 64, offset=5))
    assert np.abs(got - want).max() < 1e-6


@pytest.mark.parametrize("impl", ["full", "chunked"])
@pytest.mark.parametrize("window", [None, 5])
def test_plain_attention_functions_match(impl, window):
    """attention_full / attention_chunked (padded tail: 20 keys in chunks of
    8) with a query offset and a cache length, as decode-time callers use."""
    cfg = dataclasses.replace(CFG, sliding_window=window, attn_chunk=8)
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 7, 4, 16), np.float32)
    k, v = (rng.standard_normal((2, 20, 2, 16), np.float32) for _ in range(2))
    kw = dict(causal=True, q_offset=11, kv_len=16, impl=impl)
    got = attention.attention(cfg, *map(torch.from_numpy, (q, k, v)), **kw).numpy()
    want = np.asarray(ref_attention.attention(cfg, *map(jnp.asarray, (q, k, v)), **kw))
    assert np.abs(got - want).max() < 1e-5


# ------------------------------------------------------------------ the slice
@pytest.mark.parametrize("seq", [12, 300])  # repro: attention_full / chunked, padded
def test_forward_logits_and_cache_match(ref_params, seq):
    toks = tokens(2, seq, seed=seq)
    want, want_cache, _ = ref_forward(REF_CFG, ref_params, {"tokens": jnp.asarray(toks)},
                                      emit_cache=True)
    got, got_cache = forward(CFG, port_params(CFG, ref_params),
                             {"tokens": torch.from_numpy(toks)}, emit_cache=True)
    assert got.shape == (2, seq, CFG.vocab_size)
    assert rel_err(got, want) < 2e-4
    got_cache = carry.cache_to_arrays(got_cache)
    for name in ("k", "v"):
        assert got_cache[name].shape == want_cache[name].shape
        assert rel_err(got_cache[name], want_cache[name]) < 2e-4
    assert np.array_equal(got_cache["slot_pos"], np.asarray(want_cache["slot_pos"]))


def test_prefill_step_matches_last_logits(ref_params):
    from repro_torch.launch.steps import make_prefill_step

    toks = torch.from_numpy(tokens(2, 20, seed=9))
    params = port_params(CFG, ref_params)
    full, _ = forward(CFG, params, {"tokens": toks})
    last, cache = make_prefill_step(CFG, logits_mode="last")(params, {"tokens": toks})
    assert last.shape == (2, 1, CFG.vocab_size)
    assert rel_err(last, full[:, -1:]) < 1e-6
    assert cache["k"].shape == (CFG.n_layers, 2, 20, CFG.n_kv_heads, CFG.head_dim)


def _decode_both(cfg, ref_cfg, tree, toks):
    """Per-step logits of the reference's and the port's decode_step, and
    both final caches."""
    b, s = toks.shape
    step = jax.jit(lambda p, c, t, pos: ref_decode_step(ref_cfg, p, c, t, pos))
    ref_cache = ref_init_cache(ref_cfg, b, s)
    cache = init_cache(cfg, b, s, device="cpu")
    params = port_params(cfg, tree)
    want, got = [], []
    for t in range(s):
        lg, ref_cache = step(tree, ref_cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        want.append(np.asarray(lg[:, 0]))
        lg, cache = decode_step(cfg, params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        got.append(lg[:, 0].numpy())
    return np.stack(want, 1), np.stack(got, 1), to_np(ref_cache), cache


def test_decode_matches_reference(ref_params):
    toks = tokens(2, 12, seed=1)
    want, got, ref_cache, cache = _decode_both(CFG, REF_CFG, ref_params, toks)
    assert rel_err(got, want) < 2e-4
    full, _ = forward(CFG, port_params(CFG, ref_params), {"tokens": torch.from_numpy(toks)})
    assert rel_err(got, full) < 2e-4
    ours = carry.cache_to_arrays(cache)
    for name in ("k", "v"):
        assert rel_err(ours[name], ref_cache[name]) < 2e-4
    assert np.array_equal(ours["slot_pos"], ref_cache["slot_pos"])


def test_sliding_window_ring_buffer_matches_reference():
    """S = 20 > window 8: the ring wraps; dense family (repro's own ring
    test runs through its MoE path)."""
    tree = to_np(ref_init_model(REF_SWA, jax.random.PRNGKey(3)))
    toks = tokens(1, 20, seed=3)
    want, got, ref_cache, cache = _decode_both(SWA, REF_SWA, tree, toks)
    assert cache["k"].shape[2] == 8
    assert rel_err(got, want) < 2e-4
    full_ref, ref_pre, _ = ref_forward(REF_SWA, tree, {"tokens": jnp.asarray(toks)},
                                       emit_cache=True)
    full, pre = forward(SWA, port_params(SWA, tree), {"tokens": torch.from_numpy(toks)},
                        emit_cache=True)
    assert rel_err(full, full_ref) < 2e-4
    assert rel_err(got, full) < 2e-4
    pre = carry.cache_to_arrays(pre)
    assert np.array_equal(pre["slot_pos"], np.asarray(ref_pre["slot_pos"]))
    assert rel_err(pre["k"], ref_pre["k"]) < 2e-4


def test_without_rope_sinusoidal_positions_match():
    """use_rope=False: sinusoidal positions added to the embeddings, in
    forward and per lane in decode_step."""
    cfg = dataclasses.replace(CFG, use_rope=False)
    ref_cfg = dataclasses.replace(REF_CFG, use_rope=False)
    tree = to_np(ref_init_model(ref_cfg, jax.random.PRNGKey(4)))
    toks = tokens(2, 6, seed=6)
    want, got, _, _ = _decode_both(cfg, ref_cfg, tree, toks)
    assert rel_err(got, want) < 2e-4
    full, _ = forward(cfg, port_params(cfg, tree), {"tokens": torch.from_numpy(toks)})
    full_ref, _, _ = ref_forward(ref_cfg, tree, {"tokens": jnp.asarray(toks)})
    assert rel_err(full, full_ref) < 2e-4


def test_cache_round_trips_through_numpy(ref_params):
    toks = jnp.asarray(tokens(2, 10, seed=4))
    _, ref_cache, _ = ref_forward(REF_CFG, ref_params, {"tokens": toks}, emit_cache=True)
    ref_cache = to_np(ref_cache)
    cache = carry.cache_from_reference(CFG, ref_cache, device="cpu")
    back = carry.cache_to_arrays(cache)
    for name in ref_cache:
        assert np.array_equal(back[name], ref_cache[name])
    with pytest.raises(ValueError, match="keys"):
        carry.params_from_reference(CFG, {"embed": ref_params["embed"]}, device="cpu")


# ------------------------------------------------------------------ rwkv6
@pytest.fixture(scope="module")
def rwkv_ref_params():
    """The reference's reduced rwkv6-3b weights, with the token-shift mixes
    and the bonus u (which its schema starts at zero) drawn from numpy so
    that every path of the block carries weight."""
    tree = to_np(ref_init_model(REF_RWKV, jax.random.PRNGKey(5)))
    rng = np.random.default_rng(5)
    layers_ = tree["layers"]
    for part in ("tm", "cm"):
        layers_[part]["mu"] = rng.uniform(0, 1, layers_[part]["mu"].shape).astype(np.float32)
    layers_["tm"]["u"] = (rng.standard_normal(layers_["tm"]["u"].shape) * 0.3).astype(np.float32)
    return tree


def test_rwkv_init_matches_the_references_deterministic_leaves():
    """decay_base, zeros and ones leaves are the reference's (decay_base to
    float rounding: the two linspaces round differently); the random leaves
    have its shapes."""
    ours = dict(schema.leaf_paths(init_model(RWKV, 0, device="cpu")))
    theirs = dict(schema.leaf_paths(to_np(ref_init_model(REF_RWKV, jax.random.PRNGKey(0)))))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: v.shape for k, v in theirs.items()}
    for path in (("layers", "tm", "w0"), ("layers", "tm", "u"), ("layers", "tm", "mu"),
                 ("layers", "tm", "ln"), ("layers", "norm1", "scale")):
        assert np.abs(ours[path].numpy() - theirs[path]).max() < 1e-5, path


@pytest.mark.parametrize("seq", [12, 40])  # one chunk, and a ragged second chunk
def test_rwkv_forward_logits_and_cache_match(rwkv_ref_params, seq):
    toks = tokens(2, seq, seed=seq)
    want, want_cache, _ = ref_forward(REF_RWKV, rwkv_ref_params,
                                      {"tokens": jnp.asarray(toks)}, emit_cache=True)
    got, got_cache = forward(RWKV, port_params(RWKV, rwkv_ref_params),
                             {"tokens": torch.from_numpy(toks)}, emit_cache=True)
    assert got.shape == (2, seq, RWKV.vocab_size)
    assert rel_err(got, want) < 2e-4
    got_cache = carry.cache_to_arrays(got_cache)
    assert sorted(got_cache) == sorted(want_cache) == ["cm_prev", "tm_prev", "wkv"]
    for name in got_cache:
        assert got_cache[name].shape == want_cache[name].shape
        assert rel_err(got_cache[name], want_cache[name]) < 2e-4


def test_rwkv_decode_matches_reference(rwkv_ref_params):
    """12 decode steps: logits against repro's decode_step and against
    forward over the same tokens, and the final recurrent state."""
    toks = tokens(2, 12, seed=11)
    want, got, ref_cache, cache = _decode_both(RWKV, REF_RWKV, rwkv_ref_params, toks)
    assert rel_err(got, want) < 2e-4
    full, pre = forward(RWKV, port_params(RWKV, rwkv_ref_params),
                        {"tokens": torch.from_numpy(toks)}, emit_cache=True)
    assert rel_err(got, full) < 2e-4
    ours = carry.cache_to_arrays(cache)
    for name in ref_cache:
        assert rel_err(ours[name], ref_cache[name]) < 2e-4
        assert rel_err(ours[name], carry.cache_to_arrays(pre)[name]) < 2e-4


def test_rwkv_cache_round_trips_and_hands_off_to_decode(rwkv_ref_params):
    """The reference's prefill cache carried into the port and back is
    unchanged; decoding on from it gives the reference's next logits."""
    toks = tokens(2, 10, seed=13)
    _, ref_cache, _ = ref_forward(REF_RWKV, rwkv_ref_params, {"tokens": jnp.asarray(toks)},
                                  emit_cache=True)
    ref_cache = to_np(ref_cache)
    cache = carry.cache_from_reference(RWKV, ref_cache, device="cpu")
    back = carry.cache_to_arrays(cache)
    for name in ref_cache:
        assert np.array_equal(back[name], ref_cache[name])
    nxt = tokens(2, 1, seed=14)
    want, _ = ref_decode_step(REF_RWKV, rwkv_ref_params, ref_cache, jnp.asarray(nxt),
                              jnp.int32(10))
    got, _ = decode_step(RWKV, port_params(RWKV, rwkv_ref_params), cache,
                         torch.from_numpy(nxt), 10)
    assert rel_err(got, want) < 2e-4
