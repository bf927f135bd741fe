"""The port's mixture-of-experts block and MoE models (mixtral-8x22b,
kimi-k2-1t-a32b, reduced) against ``repro``'s, on the CPU, in fp32.

Weights are the reference's (``init_model``), carried across with
``models.carry``; inputs come from numpy. Tolerances: router gates and the
aux loss to 1e-6 absolute; dispatch and model outputs, caches and 16 decode
steps to a relative error (max |diff| / max |value|) below 2e-4, the bound
of ``tests/test_decode_equiv.py``; the dropped pairs' count and the expert
indices equal.

Routing is discontinuous: the two frameworks' fp32 router logits differ in
their last bits, which can flip a near-tie in the top-k. ``router_flips``
counts the (token, slot) pairs whose index differs and requires the gate
margin there (k-th against (k+1)-th) below 1e-5; the dispatch and model
tests require no flip on their inputs. Forward-against-decode tests take a
capacity factor at which nothing drops (``no_drop``): decode never drops,
while forward may (the reference's own ``test_swa_ring_buffer_decode`` does
the same).

The reference's ``moe_dispatch`` warns (``DeprecationWarning``, a float
handed to ``jax.nn.one_hot``; ``ROADMAP.md``, reference fault 4), which
``pytest.ini`` turns into an error; each call of it runs under
``ref_warnings_off``.
"""
import contextlib
import dataclasses
import warnings

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
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.models import carry, decode_step, forward, init_cache, moe

ARCHS = ["mixtral-8x22b", "kimi-k2-1t-a32b"]
GATE_TOL = 1e-6
MARGIN = 1e-5


def cfgs(name, **moe_changes):
    """The port's and the reference's reduced fp32 config, the MoE fields
    replaced by ``moe_changes``."""
    out = []
    for pkg in (configs, ref_configs):
        cfg = pkg.reduced(pkg.get_config(name), dtype="float32")
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_changes)))
    return out


def no_drop(name):
    """capacity_factor E / k: a buffer holds a whole group, nothing drops."""
    m = configs.reduced(configs.get_config(name)).moe
    return cfgs(name, capacity_factor=m.n_experts / m.top_k)


@contextlib.contextmanager
def ref_warnings_off():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def ref_tree(ref_cfg, seed=0):
    return to_np(ref_init_model(ref_cfg, jax.random.PRNGKey(seed)))


def layer0_moe(tree):
    return {k: v[0] for k, v in tree["layers"]["moe"].items()}


def torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def activations(shape, d, seed):
    return np.random.default_rng(seed).standard_normal(shape + (d,)).astype(np.float32)


def tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def router_flips(cfg, ref_cfg, p, x) -> int:
    """Holds the port's router to the reference's on x and returns the count
    of (token, slot) pairs whose expert differs, each at a gate margin
    below ``MARGIN``."""
    g, idx, aux = moe.router_topk(cfg, torch_tree(p), torch.from_numpy(x))
    rg, ridx, raux = ref_moe.router_topk(ref_cfg, p, jnp.asarray(x))
    rg, ridx = np.asarray(rg), np.asarray(ridx)
    assert np.abs(g.numpy() - rg).max() < GATE_TOL
    assert abs(float(aux) - float(raux)) < GATE_TOL
    differ = idx.numpy() != ridx
    if differ.any():  # a near-tie: the k-th and (k+1)-th gates all but equal
        logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ p["router"].astype(np.float64)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs = np.sort(probs / probs.sum(-1, keepdims=True), -1)[:, ::-1]
        k = cfg.moe.top_k
        margin = (probs[:, k - 1] - probs[:, k]).reshape(idx.shape[:-1])
        assert (margin[differ.any(-1)] < MARGIN).all()
    return int(differ.sum())


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("name", ARCHS)
def test_router_topk_matches(name):
    cfg, ref_cfg = cfgs(name)
    p = layer0_moe(ref_tree(ref_cfg))
    x = activations((4, 64), cfg.d_model, seed=1)
    assert router_flips(cfg, ref_cfg, p, x) == 0


def test_router_topk_matches_at_kimis_expert_count():
    """384 experts, top 8 (kimi-k2's routing) on the reduced widths:
    near-ties are likelier with more experts; any flip is counted and must
    lie within the gate margin."""
    cfg, ref_cfg = cfgs("kimi-k2-1t-a32b", n_experts=384, top_k=8)
    p = layer0_moe(ref_tree(ref_cfg, seed=3))
    x = activations((8, 128), cfg.d_model, seed=2)
    flips = router_flips(cfg, ref_cfg, p, x)
    assert flips <= 2, flips


def test_router_ties_put_the_lower_expert_first():
    """Equal gates (a zero router): jax.lax.top_k's order, index 0 first."""
    cfg, ref_cfg = cfgs("kimi-k2-1t-a32b", n_experts=8, top_k=3)
    p = {"router": np.zeros((cfg.d_model, 8), np.float32)}
    x = activations((2, 5), cfg.d_model, seed=4)
    _, idx, _ = moe.router_topk(cfg, torch_tree(p), torch.from_numpy(x))
    _, ridx, _ = ref_moe.router_topk(ref_cfg, p, jnp.asarray(x))
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert (idx.numpy() == np.arange(3)).all()


# ------------------------------------------------------------------ dispatch
# (name, batch shape, capacity factor) at the model's group size of 512: one
# group; a t of 600 that 512 does not divide (groups of gcd(600, 512) = 8);
# two groups of 512 that drop tokens; groups of 8 that drop; kimi's reduced
# config, one group and two that drop
DISPATCH = [
    ("mixtral-8x22b", (2, 256), 1.25),
    ("mixtral-8x22b", (3, 200), 1.25),
    ("mixtral-8x22b", (4, 256), 0.5),
    ("mixtral-8x22b", (3, 200), 0.5),
    ("kimi-k2-1t-a32b", (2, 96), 1.25),
    ("kimi-k2-1t-a32b", (4, 256), 0.5),
]


@pytest.mark.parametrize("name, shape, cf", DISPATCH)
def test_moe_dispatch_matches(name, shape, cf):
    cfg, ref_cfg = cfgs(name, capacity_factor=cf)
    p = layer0_moe(ref_tree(ref_cfg, seed=5))
    x = activations(shape, cfg.d_model, seed=6)
    assert router_flips(cfg, ref_cfg, p, x) == 0
    y, aux, dropped = moe.moe_dispatch(cfg, torch_tree(p), torch.from_numpy(x))
    with ref_warnings_off():
        ry, raux, rdropped = ref_moe.moe_dispatch(ref_cfg, p, jnp.asarray(x))
    assert y.shape == x.shape
    assert rel_err(y, ry) < 2e-4
    assert abs(float(aux) - float(raux)) < GATE_TOL
    # the same pairs drop: equal counts (the fp32 means round apart by an ulp)
    pairs = x.shape[0] * x.shape[1] * cfg.moe.top_k
    assert round(float(dropped) * pairs) == round(float(rdropped) * pairs)
    assert abs(float(dropped) - float(rdropped)) < GATE_TOL
    if cf < 1:
        assert float(dropped) > 0  # the case drops tokens, as it should


@pytest.mark.parametrize("t, want", [(512, (512, 320)), (600, (8, 8)), (4, (4, 4)), (1, (1, 4)),
                                     (300, (300, 188))])
def test_group_and_capacity_are_the_references(t, want):
    """mixtral reduced (E 4, top 2, cf 1.25): tg = min(512, t), its gcd
    with t where it does not divide; cap = ceil(tg·k·cf/E) up to a multiple
    of 4."""
    cfg, _ = cfgs("mixtral-8x22b")
    assert moe.group_and_capacity(cfg, t) == want


@pytest.mark.parametrize("name", ARCHS)
def test_moe_dense_matches_dispatch_without_drops(name):
    cfg, ref_cfg = no_drop(name)
    p = layer0_moe(ref_tree(ref_cfg, seed=7))
    x = torch.from_numpy(activations((2, 40), cfg.d_model, seed=8))
    y, aux, dropped = moe.moe_dispatch(cfg, torch_tree(p), x)
    yd, auxd, dropped_d = moe.moe_dense(cfg, torch_tree(p), x)
    ry, raux, _ = ref_moe.moe_dense(ref_cfg, p, jnp.asarray(x.numpy()))
    assert float(dropped) == float(dropped_d) == 0.0
    assert rel_err(y, yd) < 2e-4
    assert rel_err(yd, ry) < 2e-4
    assert float(aux) == float(auxd) and abs(float(auxd) - float(raux)) < GATE_TOL


@pytest.mark.parametrize("impl, group_size", [("dispatch", 512), ("dispatch", 64),
                                              ("dense", 512)])
@pytest.mark.parametrize("name", ARCHS)
def test_apply_moe_matches_the_reference(name, impl, group_size):
    """``apply_moe`` switches as the reference's: the dispatch at the given
    group size (at capacity factor 0.5 it drops pairs), or the dense oracle
    (which drops none)."""
    cfg, ref_cfg = cfgs(name, capacity_factor=0.5)
    p = layer0_moe(ref_tree(ref_cfg, seed=9))
    x = activations((2, 128), cfg.d_model, seed=10)
    assert router_flips(cfg, ref_cfg, p, x) == 0
    y, aux, dropped = moe.apply_moe(cfg, torch_tree(p), torch.from_numpy(x), impl=impl,
                                    group_size=group_size)
    with ref_warnings_off():
        ry, raux, rdropped = ref_moe.apply_moe(ref_cfg, p, jnp.asarray(x), impl=impl,
                                               group_size=group_size)
    assert rel_err(y, ry) < 2e-4
    assert abs(float(aux) - float(raux)) < GATE_TOL
    assert abs(float(dropped) - float(rdropped)) < GATE_TOL
    assert (float(dropped) > 0) == (impl == "dispatch")


# ------------------------------------------------------------------ models
def _decode_both(cfg, ref_cfg, tree, toks):
    """Per-step logits of the reference's and the port's decode_step, and
    both final caches."""
    b, s = toks.shape
    step = jax.jit(lambda p, c, t, pos: ref_decode_step(ref_cfg, p, c, t, pos))
    ref_cache = ref_init_cache(ref_cfg, b, s)
    cache = init_cache(cfg, b, s, device="cpu")
    params = carry.params_from_reference(cfg, tree, device="cpu")
    want, got = [], []
    for t in range(s):
        with ref_warnings_off():
            lg, ref_cache = step(tree, ref_cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        want.append(np.asarray(lg[:, 0]))
        lg, cache = decode_step(cfg, params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        got.append(lg[:, 0].numpy())
    return np.stack(want, 1), np.stack(got, 1), to_np(ref_cache), cache


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("seq", [40, 300])  # one group; t = 600, groups of 8
def test_forward_logits_and_cache_match(name, seq):
    cfg, ref_cfg = cfgs(name)
    tree = ref_tree(ref_cfg, seed=9)
    toks = tokens(2, seq, cfg.vocab_size, seed=seq)
    with ref_warnings_off():
        want, want_cache, _ = ref_forward(ref_cfg, tree, {"tokens": jnp.asarray(toks)},
                                          emit_cache=True)
    got, got_cache = forward(cfg, carry.params_from_reference(cfg, tree, device="cpu"),
                             {"tokens": torch.from_numpy(toks)}, emit_cache=True)
    assert got.shape == (2, seq, cfg.vocab_size)
    assert rel_err(got, want) < 2e-4
    got_cache = carry.cache_to_arrays(got_cache)
    assert sorted(got_cache) == sorted(want_cache) == ["k", "slot_pos", "v"]
    for name_ in ("k", "v"):
        assert got_cache[name_].shape == want_cache[name_].shape
        assert rel_err(got_cache[name_], want_cache[name_]) < 2e-4
    assert np.array_equal(got_cache["slot_pos"], np.asarray(want_cache["slot_pos"]))


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_reference_and_forward(name):
    """16 decode steps (mixtral's window of 32 is not reached; the ring is
    the next test's): against repro's decode_step and the port's forward
    over the same tokens, at a capacity that drops nothing."""
    cfg, ref_cfg = no_drop(name)
    tree = ref_tree(ref_cfg, seed=10)
    toks = tokens(2, 16, cfg.vocab_size, seed=11)
    want, got, ref_cache, cache = _decode_both(cfg, ref_cfg, tree, toks)
    assert rel_err(got, want) < 2e-4
    full, _ = forward(cfg, carry.params_from_reference(cfg, tree, device="cpu"),
                      {"tokens": torch.from_numpy(toks)})
    assert rel_err(got, full) < 2e-4
    ours = carry.cache_to_arrays(cache)
    for name_ in ("k", "v"):
        assert rel_err(ours[name_], ref_cache[name_]) < 2e-4
    assert np.array_equal(ours["slot_pos"], ref_cache["slot_pos"])


def test_mixtral_window_ring_decode_continues_forward():
    """The reference's test_swa_ring_buffer_decode setup on the port: a
    20-token prefill (window 8: the ring wraps), 16 decode steps on from its
    cache, against forward over all 36 tokens, nothing dropped."""
    cfg, ref_cfg = no_drop("mixtral-8x22b")
    cfg = dataclasses.replace(cfg, sliding_window=8)
    ref_cfg = dataclasses.replace(ref_cfg, sliding_window=8)
    tree = ref_tree(ref_cfg, seed=12)
    params = carry.params_from_reference(cfg, tree, device="cpu")
    toks = tokens(1, 36, cfg.vocab_size, seed=13)
    logits, cache = forward(cfg, params, {"tokens": torch.from_numpy(toks[:, :20])},
                            emit_cache=True)
    with ref_warnings_off():
        _, ref_pre, _ = ref_forward(ref_cfg, tree, {"tokens": jnp.asarray(toks[:, :20])},
                                    emit_cache=True)
    pre = carry.cache_to_arrays(cache)
    assert np.array_equal(pre["slot_pos"], np.asarray(ref_pre["slot_pos"]))
    assert rel_err(pre["k"], ref_pre["k"]) < 2e-4
    got = []
    for t in range(20, 36):
        lg, cache = decode_step(cfg, params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        got.append(lg[:, 0])
    full, _ = forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert rel_err(torch.stack(got, 1), full[:, 20:]) < 2e-4


def test_init_model_runs_the_moe_families_on_the_cpu():
    from repro_torch.models import init_model

    for name in ARCHS:
        cfg, _ = cfgs(name)
        params = init_model(cfg, 0, device="cpu")
        assert params["layers"]["moe"]["wi"].shape == (
            cfg.n_layers, cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert)
        logits, _ = forward(cfg, params, {"tokens": torch.zeros(1, 3, dtype=torch.int32)})
        assert torch.isfinite(logits).all()


def test_carry_refuses_a_tree_without_the_moe_leaves():
    cfg, ref_cfg = cfgs("mixtral-8x22b")
    tree = ref_tree(ref_cfg)
    del tree["layers"]["moe"]["wg"]
    with pytest.raises(ValueError, match="moe"):
        carry.params_from_reference(cfg, tree, device="cpu")
    tree["layers"]["moe"]["wg"] = tree["layers"]["moe"]["wi"]
    tree["layers"]["mlp"] = {"w1": np.zeros(1, np.float32)}
    with pytest.raises(ValueError, match="extra"):
        carry.params_from_reference(cfg, tree, device="cpu")

