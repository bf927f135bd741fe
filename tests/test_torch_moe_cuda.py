"""The MoE and hybrid families on the card against the same models on the
CPU (no JAX in this file, so it runs on a machine with the card):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

Reduced mixtral-8x22b and hymba-1.5b, fp32, seeded weights: the prefill on
the card goes through the flash kernel (one launch a layer), on the CPU
through the plain version; logits, emitted caches and decode steps agree to
a relative error below 2e-4, the bound of ``tests/test_decode_equiv.py``.
The expert routes must be the same on both devices (a flipped near-tie
would show as an error far above the bound). Without a CUDA device these
tests skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.models import decode_step, forward, init_model

ARCHS = ["mixtral-8x22b", "hymba-1.5b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the model's prefill runs the flash kernel there")
    torch.backends.cuda.matmul.allow_tf32 = False  # the CPU side is full fp32
    return torch.device("cuda")


def rel_err(got, want) -> float:
    return float((got.cpu().float() - want.float()).abs().max() / want.float().abs().max())


def to_device(tree, dev):
    return {k: to_device(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_on_the_card_matches_the_cpu(cuda_device, name):
    """300 tokens: past the reduced window of 32, and t = 600 for the MoE
    dispatch (groups of gcd(600, 512) = 8)."""
    cfg = reduced(get_config(name), dtype="float32")
    params = init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 300)).astype(np.int32))
    want, want_cache = forward(cfg, params, {"tokens": toks}, emit_cache=True)
    before = K.flash_attention_bhsd.launches
    got, got_cache = forward(cfg, to_device(params, cuda_device),
                             {"tokens": toks.to(cuda_device)}, emit_cache=True)
    torch.cuda.synchronize()
    assert K.flash_attention_bhsd.launches == before + cfg.n_layers
    assert rel_err(got, want) < 2e-4
    assert sorted(got_cache) == sorted(want_cache)
    for leaf in want_cache:
        if leaf == "slot_pos":
            assert torch.equal(got_cache[leaf].cpu(), want_cache[leaf])
        else:
            assert rel_err(got_cache[leaf], want_cache[leaf]) < 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCHS)
def test_decode_on_the_card_matches_the_cpu(cuda_device, name):
    """16 decode steps from an empty cache on both devices."""
    from repro_torch.models import init_cache

    cfg = reduced(get_config(name), dtype="float32")
    params = init_model(cfg, 2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    card = to_device(params, cuda_device)
    cache_cpu = init_cache(cfg, 2, 16, device="cpu")
    cache_card = init_cache(cfg, 2, 16, device=cuda_device)
    for t in range(16):
        want, cache_cpu = decode_step(cfg, params, cache_cpu, toks[:, t:t + 1], t)
        got, cache_card = decode_step(cfg, card, cache_card, toks[:, t:t + 1].to(cuda_device), t)
        assert rel_err(got, want) < 2e-4
    for leaf in cache_cpu:
        if leaf != "slot_pos":
            assert rel_err(cache_card[leaf], cache_cpu[leaf]) < 2e-4
