"""The port's serving engine against ``repro``'s, on the CPU.

Both engines serve the same requests with the same weights (the
reference's, carried across) and greedy sampling, and must emit identical
tokens. The config is the reduced internlm2-1.8b in fp32: the engine's
logic is the point, and bf16 rounds at different places in the two
frameworks, which could flip a near-tie argmax.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import init_model as ref_init_model
from repro.train.serve import Request as RefRequest
from repro.train.serve import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import carry, init_cache, init_model
from repro_torch.train.serve import Request, ServeEngine

CFG = configs.reduced(configs.get_config("internlm2-1.8b"), dtype="float32")
REF_CFG = ref_configs.reduced(ref_configs.get_config("internlm2-1.8b"), dtype="float32")


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(np.asarray, ref_init_model(REF_CFG, jax.random.PRNGKey(2)))
    return tree, carry.params_from_reference(CFG, tree, device="cpu")


def prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, int(rng.integers(2, 12))).astype(np.int32)
            for _ in range(n)]


def serve(engine, request, ps, max_new):
    for rid, p in enumerate(ps):
        engine.submit(request(rid=rid, prompt=p, max_new=max_new))
    done = engine.run_until_drained()
    return {r.rid: list(r.out) for r in done}, engine.steps


def test_greedy_tokens_equal_the_references(weights):
    tree, params = weights
    ps = prompts(6)
    want, ref_steps = serve(RefServeEngine(REF_CFG, tree, slots=2, max_len=64),
                            RefRequest, ps, 8)
    got, steps = serve(ServeEngine(CFG, params, slots=2, max_len=64), Request, ps, 8)
    assert sorted(got) == list(range(6))
    assert got == want
    assert steps == ref_steps


def test_max_len_ends_a_request(weights):
    _, params = weights
    got, _ = serve(ServeEngine(CFG, params, slots=2, max_len=12), Request,
                   [np.arange(2, 10, dtype=np.int32)], 16)
    assert len(got[0]) == 3  # positions 8, 9, 10 decode; 11 = max_len - 1 stops


def test_temperature_sampling_follows_its_seed(weights):
    _, params = weights
    ps = prompts(3, seed=1)
    runs = [serve(ServeEngine(CFG, params, slots=2, max_len=64, temperature=1.0,
                              seed=seed), Request, ps, 6)[0] for seed in (5, 5, 6)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert all(0 <= t < CFG.vocab_size for out in runs[0].values() for t in out)


def test_decode_step_writes_the_cache_in_place(weights):
    _, params = weights
    cache = init_cache(CFG, 2, 8, device="cpu")
    k = cache["k"]
    logits, out = make_decode_step(CFG)(params, cache, torch.tensor([[3], [4]]), 0)
    assert logits.shape == (2, 1, CFG.vocab_size)
    assert out is cache and out["k"] is k
    assert out["slot_pos"][:, :, 0].eq(0).all() and out["slot_pos"][:, :, 1:].eq(-1).all()
    assert k[:, :, 0].abs().sum() > 0 and k[:, :, 1:].abs().sum() == 0


def test_launcher_serves_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "internlm2-1.8b", "--reduced", "--requests", "3",
                             "--slots", "2", "--max-new", "4", "--device", "cpu"])
    assert out["requests"] == 3 and out["tokens"] == 12
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


# ------------------------------------------------------------------ rwkv6
RWKV = configs.reduced(configs.get_config("rwkv6-3b"), dtype="float32", vocab_size=128)
REF_RWKV = ref_configs.reduced(ref_configs.get_config("rwkv6-3b"), dtype="float32",
                               vocab_size=128)


@pytest.fixture(scope="module")
def rwkv_weights():
    """The port's seeded init as numpy arrays, for both engines: the
    reference's init seeds each leaf from the per-process string hash, and
    some of its draws make every request emit the same token, which would
    hide a leak. The token-shift mixes and the bonus, zero in the schema,
    are drawn from numpy."""
    tree = jax.tree.map(lambda t: t.numpy(), init_model(RWKV, 0, device="cpu"))
    rng = np.random.default_rng(0)
    for part in ("tm", "cm"):
        mu = tree["layers"][part]["mu"]
        tree["layers"][part]["mu"] = rng.uniform(0, 1, mu.shape).astype(np.float32)
    u = tree["layers"]["tm"]["u"]
    tree["layers"]["tm"]["u"] = (rng.standard_normal(u.shape) * 0.3).astype(np.float32)
    return tree, carry.params_from_reference(RWKV, tree, device="cpu")


def test_rwkv_requests_keep_their_own_state(rwkv_weights):
    """Every request served by a 4-slot port engine (prompts admitted while
    other lanes decode, slots reused) gets the greedy tokens the reference
    engine gives it alone in one slot: no lane's recurrent state moves while
    another lane is fed, and a slot starts each request from zero state."""
    tree, params = rwkv_weights
    rng = np.random.default_rng(3)
    ps = [rng.integers(0, RWKV.vocab_size, int(rng.integers(2, 8))).astype(np.int32)
          for _ in range(6)]
    got, _ = serve(ServeEngine(RWKV, params, slots=4, max_len=64), Request, ps, 6)
    alone = {rid: serve(RefServeEngine(REF_RWKV, tree, slots=1, max_len=64), RefRequest,
                        [p], 6)[0][0] for rid, p in enumerate(ps)}
    assert sorted(got) == list(range(6))
    assert got == alone
    assert len({tuple(t) for t in got.values()}) > 1  # the requests' tokens differ


def test_launcher_serves_rwkv_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "rwkv6-3b", "--reduced", "--requests", "3",
                             "--slots", "2", "--max-new", "4", "--device", "cpu"])
    assert out["requests"] == 3 and out["tokens"] == 12
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
