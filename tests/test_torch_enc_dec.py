"""The port's encoder-decoder family (whisper-large-v3, reduced) against
``repro``'s, on the CPU, in fp32.

Weights are the reference's (``init_model``), with every leaf its schema
starts at zeros or ones (biases, norm scales) drawn from numpy so that each
carries its own weight, carried across with ``models.carry``; tokens and
frame embeddings come from numpy. The encoder output, the logits, the
emitted caches (the decoder's K/V and the cross K/V ``ck``/``cv``) and 12
decode steps agree to a relative error (max |diff| / max |value|) below
2e-4, the bound of ``tests/test_decode_equiv.py``.
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
from repro.models import schema as ref_schema
from repro.models import transformer as ref_transformer
from repro_torch import configs
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import carry, decode_step, forward, init_cache, schema, transformer
from repro_torch.train.serve import ServeEngine

ARCH = "whisper-large-v3"
CFG = configs.reduced(configs.get_config(ARCH), dtype="float32")
REF_CFG = ref_configs.reduced(ref_configs.get_config(ARCH), dtype="float32")
TOL = 2e-4


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def with_random_constants(cfg, tree, seed):
    """``tree`` with each leaf that the schema starts at zeros or ones
    moved off it by numpy noise."""
    rng = np.random.default_rng(seed)
    for path, p in schema.leaf_paths(transformer.model_schema(cfg)):
        if p.init in ("zeros", "ones"):
            node = tree
            for key in path[:-1]:
                node = node[key]
            base = 1.0 if p.init == "ones" else 0.0
            node[path[-1]] = (base + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def tree():
    return with_random_constants(CFG, to_np(ref_init_model(REF_CFG, jax.random.PRNGKey(0))), 0)


@pytest.fixture(scope="module")
def params(tree):
    return carry.params_from_reference(CFG, tree, device="cpu")


def tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


def frames(b, seed):
    return (np.random.default_rng(seed).standard_normal((b, CFG.encoder_seq, CFG.d_model))
            * 0.5).astype(np.float32)


def batches(toks, fr):
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)},
            {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(fr)})


# ------------------------------------------------------------------ schema
@pytest.mark.parametrize("sized", ["reduced", "full"])
def test_schema_is_the_references(sized):
    """Every leaf (the encoder subtree, the decoder's norm_c and cross) with
    the reference's shape and init; block schemas by flag alike."""
    cfg, ref_cfg = CFG, REF_CFG
    if sized == "full":
        cfg, ref_cfg = configs.get_config(ARCH), ref_configs.get_config(ARCH)
    ours = dict(schema.leaf_paths(transformer.model_schema(cfg)))
    theirs = dict(ref_schema._leaf_paths(ref_transformer.model_schema(ref_cfg)))
    assert {k: (v.shape, v.init) for k, v in ours.items()} == {
        k: (v.shape, v.init) for k, v in theirs.items()}
    assert ("encoder", "final_norm", "bias") in ours
    assert ours[("encoder", "layers", "mlp", "w1")].shape[0] == cfg.n_encoder_layers
    assert ("layers", "cross", "wq") in ours and ("layers", "norm_c", "scale") in ours
    for flags in ({"encoder": True}, {"decoder_cross": True}, {}):
        ours = dict(schema.leaf_paths(transformer.block_schema(cfg, **flags)))
        theirs = dict(ref_schema._leaf_paths(ref_transformer.block_schema(ref_cfg, **flags)))
        assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}


def test_cache_spec_is_the_references():
    spec = transformer.cache_spec(CFG, 3, 20)
    ref_spec = ref_transformer.cache_spec(REF_CFG, 3, 20)
    assert {k: v[0] for k, v in spec.items()} == {k: v[0] for k, v in ref_spec.items()}
    assert spec["ck"] == spec["cv"] == (
        (CFG.n_layers, 3, CFG.encoder_seq, CFG.n_kv_heads, CFG.head_dim), torch.float32)
    cache = init_cache(CFG, 3, 20, device="cpu")
    assert not cache["ck"].any() and not cache["cv"].any()
    bf16 = transformer.cache_spec(configs.reduced(configs.get_config(ARCH)), 1, 4)
    assert bf16["ck"][1] == torch.bfloat16


def test_carry_takes_the_encoder_and_cross_leaves(tree, params):
    assert torch.equal(params["encoder"]["layers"]["attn"]["wq"],
                       torch.from_numpy(np.array(tree["encoder"]["layers"]["attn"]["wq"])))
    assert torch.equal(params["layers"]["cross"]["bo"],
                       torch.from_numpy(np.array(tree["layers"]["cross"]["bo"])))
    without = {k: v for k, v in tree.items() if k != "encoder"}
    with pytest.raises(ValueError, match="missing.*encoder"):
        carry.params_from_reference(CFG, without, device="cpu")
    extra = dict(tree, layers={**tree["layers"], "moe": tree["layers"]["mlp"]})
    with pytest.raises(ValueError, match="extra.*moe"):
        carry.params_from_reference(CFG, extra, device="cpu")


# ------------------------------------------------------------------ encoder
def test_run_encoder_matches(tree, params):
    fr = frames(2, seed=1)
    want = ref_transformer.run_encoder(REF_CFG, tree, jnp.asarray(fr))
    got = transformer.run_encoder(CFG, params, torch.from_numpy(fr))
    assert got.shape == (2, CFG.encoder_seq, CFG.d_model)
    assert rel_err(got, want) < TOL


def test_encoder_self_attention_is_not_causal(params):
    """A later frame changes the encoder output at the first frame (a causal
    encoder would leave it as it was)."""
    fr = torch.from_numpy(frames(1, seed=2))
    moved = fr.clone()
    moved[:, -1] = torch.from_numpy(frames(1, seed=3))[:, 0]
    a = transformer.run_encoder(CFG, params, fr)
    b = transformer.run_encoder(CFG, params, moved)
    assert (a[:, 0] - b[:, 0]).abs().max() > 1e-4


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("seq", [12, 300])  # repro: attention_full / chunked, padded
def test_forward_logits_and_cache_match(tree, params, seq):
    ref_batch, batch = batches(tokens(2, seq, seed=seq), frames(2, seed=seq))
    want, want_cache, _ = ref_forward(REF_CFG, tree, ref_batch, emit_cache=True)
    got, got_cache = forward(CFG, params, batch, emit_cache=True)
    assert got.shape == (2, seq, CFG.vocab_size)
    assert rel_err(got, want) < TOL
    got_cache = carry.cache_to_arrays(got_cache)
    assert sorted(got_cache) == sorted(want_cache) == ["ck", "cv", "k", "slot_pos", "v"]
    for name in ("k", "v", "ck", "cv"):
        assert got_cache[name].shape == want_cache[name].shape
        assert rel_err(got_cache[name], want_cache[name]) < TOL
    assert np.array_equal(got_cache["slot_pos"], np.asarray(want_cache["slot_pos"]))


def test_cross_attention_reaches_the_kernel_unmasked(params, monkeypatch):
    """Prefill sends every attention through ``flash_attention``: the
    encoder's without a causal mask, the decoder's own causal, the cross-
    attention with neither a causal mask nor a window, its keys the
    encoder's frames (no row is without keys: ROADMAP.md §3's watch does
    not apply). Decode's cross-attention is plain and calls it not."""
    calls = []
    real = transformer.flash_attention

    def record(q, k, v, *, causal, window):
        calls.append((q.shape[1], k.shape[1], causal, window))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(transformer, "flash_attention", record)
    _, batch = batches(tokens(2, 9, seed=4), frames(2, seed=4))
    _, cache = forward(CFG, params, batch, emit_cache=True)
    s_enc, L = CFG.encoder_seq, CFG.n_layers
    assert calls[:CFG.n_encoder_layers] == [(s_enc, s_enc, False, None)] * CFG.n_encoder_layers
    assert calls[CFG.n_encoder_layers:] == [(9, 9, True, None), (9, s_enc, False, None)] * L
    calls.clear()
    cache = make_decode_step(CFG)(params, carry_on(cache, 10), batch["tokens"][:, :1], 9)[1]
    assert calls == []


def carry_on(cache, new_len):
    """A prefill cache in a decode cache of ``new_len`` slots."""
    out = init_cache(CFG, cache["k"].shape[1], new_len, device="cpu")
    s = cache["k"].shape[2]
    for name, leaf in cache.items():
        if name in ("k", "v", "slot_pos"):
            out[name][:, :, :s] = leaf
        else:
            out[name].copy_(leaf)
    return out


def test_prefill_step_passes_the_frames_through(params):
    _, batch = batches(tokens(2, 7, seed=5), frames(2, seed=5))
    full, _ = forward(CFG, params, batch)
    last, cache = make_prefill_step(CFG, logits_mode="last")(params, batch)
    assert rel_err(last, full[:, -1:]) < 1e-6
    assert cache["ck"].shape == (CFG.n_layers, 2, CFG.encoder_seq, CFG.n_kv_heads,
                                 CFG.head_dim)


# ------------------------------------------------------------------ decode
def test_decode_matches_reference_and_forward(tree, params):
    """The contract of test_decode_equiv.py: the cross K/V from a prefill,
    then 12 decode steps from position 0, against repro's decode_step, the
    port's forward over the same tokens, and the reference's final cache."""
    toks, fr = tokens(2, 12, seed=6), frames(2, seed=6)
    ref_batch, batch = batches(toks, fr)
    _, ref_pre, _ = ref_forward(REF_CFG, tree, ref_batch, emit_cache=True)
    ref_cache = ref_init_cache(REF_CFG, 2, 12)
    ref_cache["ck"], ref_cache["cv"] = ref_pre["ck"], ref_pre["cv"]
    full, pre = forward(CFG, params, batch, emit_cache=True)
    cache = init_cache(CFG, 2, 12, device="cpu")
    cache["ck"].copy_(pre["ck"])
    cache["cv"].copy_(pre["cv"])
    step = jax.jit(lambda p, c, t, pos: ref_decode_step(REF_CFG, p, c, t, pos))
    want, got = [], []
    for t in range(12):
        lg, ref_cache = step(tree, ref_cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        want.append(np.asarray(lg[:, 0]))
        lg, cache = decode_step(CFG, params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        got.append(lg[:, 0].numpy())
    want, got = np.stack(want, 1), np.stack(got, 1)
    assert rel_err(got, want) < TOL
    assert rel_err(got, full) < TOL
    ours, ref_cache = carry.cache_to_arrays(cache), to_np(ref_cache)
    for name in ("k", "v", "ck", "cv"):
        assert rel_err(ours[name], ref_cache[name]) < TOL
    assert np.array_equal(ours["slot_pos"], ref_cache["slot_pos"])


def test_prefill_cache_hands_off_to_decode(tree, params):
    """The reference's 8-token prefill cache carried into the port and back
    unchanged; 4 decode steps on from it against forward over all 12."""
    toks, fr = tokens(1, 12, seed=7), frames(1, seed=7)
    _, ref_pre, _ = ref_forward(REF_CFG, tree, batches(toks[:, :8], fr)[0], emit_cache=True)
    ref_pre = to_np(ref_pre)
    cache = carry.cache_from_reference(CFG, ref_pre, device="cpu")
    back = carry.cache_to_arrays(cache)
    for name in ref_pre:
        assert np.array_equal(back[name], ref_pre[name])
    cache = carry_on(cache, 12)
    got = []
    for t in range(8, 12):
        lg, cache = decode_step(CFG, params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        got.append(lg[:, 0])
    full, _ = forward(CFG, params, batches(toks, fr)[1])
    assert rel_err(torch.stack(got, 1), full[:, 8:]) < TOL


def test_serving_refuses_the_encoder_decoder(params):
    """The reference's engine serves LMs only (it asserts so); the port's
    refuses whisper the same way."""
    with pytest.raises(ValueError, match="LM serving only"):
        ServeEngine(CFG, params)
