"""The port's model inputs (``models/frontends.py``) and the vision-frontend
family (internvl2-2b, reduced) against ``repro``'s, on the CPU.

``input_specs`` gives the reference's shapes and dtypes for every
architecture and every shape of ``SHAPES``. internvl2's patch embeddings go
in front of the text: the logits and caches of a vision prefill, the decode
steps after it and the serving engine's tokens equal the reference's, in
fp32, to a relative error below 2e-4 (``tests/test_decode_equiv.py``'s
bound) and exactly for tokens.
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
from repro.models import input_specs as ref_input_specs
from repro.train.serve import Request as RefRequest
from repro.train.serve import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import (
    carry,
    decode_step,
    forward,
    init_cache,
    input_specs,
    synth_inputs,
    transformer,
)
from repro_torch.train.serve import Request, ServeEngine

ARCH = "internvl2-2b"
CFG = configs.reduced(configs.get_config(ARCH), dtype="float32")
REF_CFG = ref_configs.reduced(ref_configs.get_config(ARCH), dtype="float32")
P = CFG.n_frontend_tokens
TOL = 2e-4


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def flat(tree, prefix=()):
    """{path: (shape, dtype name)} of a spec tree: the reference's
    ShapeDtypeStructs or the port's (shape, torch dtype) pairs."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items() for k, v in flat(sub, prefix + (name,)).items()}
    if isinstance(tree, tuple):
        shape, dt = tree
        return {prefix: (tuple(shape), str(dt).removeprefix("torch."))}
    return {prefix: (tuple(tree.shape), jnp.dtype(tree.dtype).name)}


def leaves(tree, prefix=()):
    """{path: tensor} of a tree of tensors."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in leaves(sub, prefix + (name,)).items()}
    return {prefix: tree}


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("name", sorted(configs.REGISTRY))
def test_input_specs_are_the_references(name):
    """Every shape of SHAPES (train, prefill, decode, long decode)."""
    cfg, ref_cfg = configs.get_config(name), ref_configs.get_config(name)
    for shape in configs.SHAPES:
        ours = flat(input_specs(cfg, configs.SHAPES[shape]))
        theirs = flat(ref_input_specs(ref_cfg, ref_configs.SHAPES[shape]))
        assert ours == theirs, shape


@pytest.mark.parametrize("name", ["internvl2-2b", "whisper-large-v3", "rwkv6-3b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_synth_inputs_follow_the_specs(name, kind):
    """Small shapes: every leaf has its spec's shape and dtype, ints lie in
    [0, min(vocab, 1000)), floats are small, a decode cache is empty, and
    the same seed gives the same inputs."""
    cfg = configs.reduced(configs.get_config(name))
    shape = configs.ShapeConfig("small", kind, 24, 2)
    got = synth_inputs(cfg, shape, 3, device="cpu")
    assert {path: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for path, x in leaves(got).items()} == flat(input_specs(cfg, shape))
    for path, x in leaves(got).items():
        if x.dtype == torch.int32 and "cache" not in path:
            assert int(x.min()) >= 0 and int(x.max()) < min(cfg.vocab_size, 1000)
        elif x.is_floating_point() and "cache" not in path:
            assert 0 < float(x.float().std()) < 0.05
    if kind == "decode":
        assert int(got["pos"]) == 0
        assert all(not leaf.any() for k, leaf in got["cache"].items() if k != "slot_pos")
        assert (got["cache"].get("slot_pos", torch.tensor(-1)) == -1).all()
    again = synth_inputs(cfg, shape, 3, device="cpu")
    assert all(torch.equal(a, again_leaf) for a, again_leaf in
               zip(leaves(got).values(), leaves(again).values()))


def test_synth_inputs_run_forward_for_the_new_families():
    for name in ("internvl2-2b", "whisper-large-v3"):
        cfg = configs.reduced(configs.get_config(name), dtype="float32")
        params = transformer.init_model(cfg, 0, device="cpu")
        batch = synth_inputs(cfg, configs.ShapeConfig("p", "prefill", 20, 2),
                             device="cpu")["batch"]
        logits, cache = forward(cfg, params, batch, emit_cache=True)
        assert logits.shape == (2, 20, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        assert cache["k"].shape[2] == 20


# ------------------------------------------------------------------ internvl2
@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, ref_init_model(REF_CFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def params(tree):
    return carry.params_from_reference(CFG, tree, device="cpu")


def vision_batch(b, s_text, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab_size, (b, s_text)).astype(np.int32)
    patches = (rng.standard_normal((b, P, CFG.d_model)) * 0.5).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)},
            {"tokens": torch.from_numpy(toks), "patch_embeds": torch.from_numpy(patches)})


@pytest.mark.parametrize("s_text", [12, 300])  # repro: attention_full / chunked
def test_forward_with_patches_matches(tree, params, s_text):
    ref_batch, batch = vision_batch(2, s_text, seed=s_text)
    want, want_cache, _ = ref_forward(REF_CFG, tree, ref_batch, emit_cache=True)
    got, got_cache = forward(CFG, params, batch, emit_cache=True)
    assert got.shape == (2, P + s_text, CFG.vocab_size)
    assert rel_err(got, want) < TOL
    got_cache = carry.cache_to_arrays(got_cache)
    assert sorted(got_cache) == sorted(want_cache) == ["k", "slot_pos", "v"]
    for name in ("k", "v"):
        assert got_cache[name].shape == want_cache[name].shape
        assert rel_err(got_cache[name], want_cache[name]) < TOL
    assert np.array_equal(got_cache["slot_pos"], np.asarray(want_cache["slot_pos"]))


def test_patches_change_the_text_logits(params):
    """The text attends to the patches in front of it."""
    _, batch = vision_batch(1, 6, seed=1)
    a, _ = forward(CFG, params, batch)
    other = dict(batch, patch_embeds=batch["patch_embeds"].flip(1))
    b, _ = forward(CFG, params, other)
    assert (a[:, P:] - b[:, P:]).abs().max() > 1e-4


def test_decode_after_a_vision_prefill(tree, params):
    """A prefill over 8 patches and 10 text tokens, then 8 decode steps
    (positions 18-25) against forward over patches and all 18 tokens, and
    against the reference's decode_step from its own prefill cache."""
    ref_batch, batch = vision_batch(2, 18, seed=2)
    head = {"tokens": batch["tokens"][:, :10], "patch_embeds": batch["patch_embeds"]}
    ref_head = {"tokens": ref_batch["tokens"][:, :10],
                "patch_embeds": ref_batch["patch_embeds"]}
    _, pre = make_prefill_step(CFG)(params, head)
    _, ref_pre, _ = ref_forward(REF_CFG, tree, ref_head, emit_cache=True)
    n = P + 18
    cache = init_cache(CFG, 2, n, device="cpu")
    ref_cache = ref_init_cache(REF_CFG, 2, n)
    for name in ("k", "v", "slot_pos"):
        cache[name][:, :, :P + 10] = pre[name]
        ref_cache[name] = ref_cache[name].at[:, :, :P + 10].set(ref_pre[name])
    step = jax.jit(lambda p, c, t, pos: ref_decode_step(REF_CFG, p, c, t, pos))
    got, want = [], []
    for t in range(10, 18):
        tok = batch["tokens"][:, t:t + 1]
        lg, cache = decode_step(CFG, params, cache, tok, P + t)
        got.append(lg[:, 0])
        lg, ref_cache = step(tree, ref_cache, jnp.asarray(tok.numpy()), jnp.int32(P + t))
        want.append(np.asarray(lg[:, 0]))
    full, _ = forward(CFG, params, batch)
    got = torch.stack(got, 1)
    assert rel_err(got, full[:, P + 10:]) < TOL
    assert rel_err(got, np.stack(want, 1)) < TOL


def test_prefill_step_passes_the_patches_through(params):
    _, batch = vision_batch(2, 5, seed=3)
    full, _ = forward(CFG, params, batch)
    last, cache = make_prefill_step(CFG, logits_mode="last")(params, batch)
    assert rel_err(last, full[:, -1:]) < 1e-6
    assert cache["k"].shape[2] == P + 5


def test_serving_tokens_equal_the_references(tree, params):
    """Text prompts, as the reference's engine serves a VLM: the same greedy
    tokens and the same number of engine steps."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, CFG.vocab_size, int(rng.integers(2, 12))).astype(np.int32)
               for _ in range(6)]

    def serve(engine, request):
        for rid, p in enumerate(prompts):
            engine.submit(request(rid=rid, prompt=p, max_new=8))
        return {r.rid: list(r.out) for r in engine.run_until_drained()}, engine.steps

    want = serve(RefServeEngine(REF_CFG, tree, slots=2, max_len=64), RefRequest)
    got = serve(ServeEngine(CFG, params, slots=2, max_len=64), Request)
    assert sorted(got[0]) == list(range(6))
    assert got == want


def test_serve_launcher_runs_internvl2_reduced():
    out = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--requests", "3", "--max-new", "4"])
    assert out["requests"] == 3 and out["tokens"] == 12
