"""The port's optimizer, schedule and data pipeline against ``repro``'s, on
the CPU: one AdamW update (clipped and not, fp32 and bf16 moments),
global-norm clipping, the cosine schedule over steps 0-200, and the
synthetic token stream and the lease-driven sharded loader byte for byte.

Inputs come from numpy. Limits: parameters and moments after an update to
a relative 1e-6 per leaf (the same fp32 arithmetic in the same order; the
global norm is summed in another order), bf16 moments to one bf16 rounding
(2^-8 relative); the schedule to 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import ShardedLoader as RefLoader
from repro.data import SyntheticTokens as RefTokens
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import cosine_schedule as ref_cosine
from repro_torch.data import ShardedLoader, SyntheticTokens
from repro_torch.models.schema import leaf_paths, map_tree
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule

SHAPES = {"embed": (11, 6), "layers": {"w1": (2, 6, 9), "scale": (2, 6)}, "bias": (5,)}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def random_state(seed, grad_scale):
    rng = np.random.default_rng(seed)
    params = map_tree(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))
    grads = map_tree(SHAPES, lambda s: (grad_scale * rng.standard_normal(s)).astype(np.float32))
    m = map_tree(SHAPES, lambda s: (0.01 * rng.standard_normal(s)).astype(np.float32))
    v = map_tree(SHAPES, lambda s: (1e-4 * rng.random(s)).astype(np.float32))
    return params, grads, m, v


def torch_tree(tree):
    return map_tree(tree, lambda a: torch.from_numpy(a.copy()))


@pytest.mark.parametrize("grad_scale, max_norm", [(0.01, 1.0), (3.0, 1.0), (3.0, None)],
                         ids=["unclipped", "clipped", "no-clip"])
def test_one_adamw_update_matches(grad_scale, max_norm):
    params, grads, m, v = random_state(0, grad_scale)
    step = 7
    ref_state = {"m": map_tree(m, jnp.asarray), "v": map_tree(v, jnp.asarray),
                 "step": jnp.int32(step)}
    rp, rs, rmet = ref_adamw_update(map_tree(params, jnp.asarray),
                                    map_tree(grads, jnp.asarray), ref_state, lr=3e-3,
                                    max_grad_norm=max_norm)
    state = {"m": torch_tree(m), "v": torch_tree(v), "step": torch.tensor(step, dtype=torch.int32)}
    pp, ps, met = adamw_update(torch_tree(params), torch_tree(grads), state, lr=3e-3,
                               max_grad_norm=max_norm)
    assert float(met["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]), rel=1e-6)
    assert int(ps["step"]) == int(rs["step"]) == step + 1
    for got, want in ((pp, rp), (ps["m"], rs["m"]), (ps["v"], rs["v"])):
        for (path, g), (_, w) in zip(leaf_paths(got), leaf_paths(want)):
            assert rel(g.numpy(), np.asarray(w)) < 1e-6, path


def test_bf16_moments_match():
    params, grads, _, _ = random_state(1, 0.1)
    rs = ref_adamw_init(map_tree(params, jnp.asarray), moment_dtype=jnp.bfloat16)
    rp, rs, _ = ref_adamw_update(map_tree(params, jnp.asarray),
                                 map_tree(grads, jnp.asarray), rs, lr=1e-2)
    ps = adamw_init(torch_tree(params), moment_dtype=torch.bfloat16)
    pp, ps, _ = adamw_update(torch_tree(params), torch_tree(grads), ps, lr=1e-2)
    for (path, g), (_, w) in zip(leaf_paths(ps["m"]), leaf_paths(rs["m"])):
        assert g.dtype == torch.bfloat16
        assert rel(g.float().numpy(), np.asarray(w, np.float32)) < 2.0 ** -8, path
    for (path, g), (_, w) in zip(leaf_paths(pp), leaf_paths(rp)):
        assert rel(g.numpy(), np.asarray(w)) < 1e-6, path


def test_adamw_init_is_the_references():
    params, *_ = random_state(2, 1.0)
    rs = ref_adamw_init(map_tree(params, jnp.asarray))
    ps = adamw_init(torch_tree(params))
    assert int(ps["step"]) == int(rs["step"]) == 0 and ps["step"].dtype == torch.int32
    for (path, g), (_, w) in zip(leaf_paths(ps["m"]), leaf_paths(rs["m"])):
        assert g.shape == np.shape(w) and g.dtype == torch.float32 and not g.any(), path


def test_clip_by_global_norm_matches():
    _, grads, _, _ = random_state(3, 2.0)
    rc, rn = ref_clip(map_tree(grads, jnp.asarray), 1.0)
    pc, pn = clip_by_global_norm(torch_tree(grads), 1.0)
    assert float(pn) == pytest.approx(float(rn), rel=1e-6)
    for (path, g), (_, w) in zip(leaf_paths(pc), leaf_paths(rc)):
        assert rel(g.numpy(), np.asarray(w)) < 1e-6, path


@pytest.mark.parametrize("warmup, total", [(20, 200), (0, 100), (50, 50)])
def test_cosine_schedule_matches_over_steps_0_to_200(warmup, total):
    for s in range(201):
        want = float(ref_cosine(jnp.int32(s), peak_lr=3e-4, warmup_steps=warmup,
                                total_steps=total))
        got = float(cosine_schedule(torch.tensor(s, dtype=torch.int32), peak_lr=3e-4,
                                    warmup_steps=warmup, total_steps=total))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


@pytest.mark.parametrize("seed, shard, step", [(0, 0, 0), (0, 3, 7), (5, 1, 123), (9, 7, 2)])
def test_synthetic_batches_are_byte_identical(seed, shard, step):
    ref, port = RefTokens(300, 24, seed=seed), SyntheticTokens(300, 24, seed=seed)
    assert np.array_equal(port.table, ref.table)
    want, got = ref.batch(shard, step, 5), port.batch(shard, step, 5)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].tobytes() == want[key].tobytes()


def test_loader_batches_and_shard_handoff_match():
    """Both loaders over the same lease-driven shard sets, which change
    mid-run (a handoff), emit the same bytes batch after batch."""
    owned = {"now": [0, 1]}
    ref = RefLoader(RefTokens(97, 12, seed=4), 4, 4, owned_shards=lambda: owned["now"])
    port = ShardedLoader(SyntheticTokens(97, 12, seed=4), 4, 4,
                         owned_shards=lambda: owned["now"])
    for i, shards in enumerate([[0, 1], [0, 1], [1], [1, 2, 3], [3], [0, 2]]):
        owned["now"] = shards
        want, got = ref.next_batch(), port.next_batch()
        for key in want:
            assert got[key].tobytes() == want[key].tobytes(), (i, key)
    assert port.step_per_shard == ref.step_per_shard
    owned["now"] = []
    with pytest.raises(RuntimeError, match="lease-starved"):
        port.next_batch()
