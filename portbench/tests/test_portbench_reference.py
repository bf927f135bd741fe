"""The plain references against the port at tiny sizes on the CPU (the port
in fp32 there takes its kernels' plain versions), the exact chunked WKV
against the token-by-token recurrence, and the yardstick's counts against
hand-worked values."""
from __future__ import annotations

import json

import pytest
import torch
from conftest import BENCH, tiny_cell

from pbench import flops, harness, traffic, weights
from pbench.drivers import prefill, train
from pbench.reference import rwkv6 as ref_rwkv6

PAIRS = ("internlm2-1.8b", "rwkv6-3b")


@pytest.mark.parametrize("config", PAIRS)
def test_prefill_reference_matches_the_port_in_fp32(config):
    from repro_torch.launch.steps import make_prefill_step

    cell = tiny_cell(f"{config}.prefill_2k-32k", dtype="float32")
    m = cell.model
    W = weights.make(harness.reference(cell).leaves(m), 11, "cpu")
    tokens = traffic.prompts(cell.traffic, m["vocab_size"], 11, "cpu")[0][1]
    logits, cache = make_prefill_step(harness.program_config(m))(W, {"tokens": tokens[None]})
    want_logits, want_layers = prefill.reference_outputs(cell, W, tokens)
    got = prefill.compare_request(cell, logits[0, -1], cache, int(logits[0, -1].argmax()),
                                  want_logits, want_layers)
    assert set(got) >= {"logits", "token_gap"} | {f"cache_{k}" for k in want_layers[0]}
    assert max(got.values()) < 1e-4, got


@pytest.mark.parametrize("config", PAIRS)
def test_training_reference_matches_the_port_in_fp32(config):
    cell = tiny_cell(f"{config}.train_4k", dtype="float32")
    tr, prog = train.first_steps(cell, 12, "cpu")
    ref = train.reference_steps(cell, 12, "cpu")
    got = train.compare(prog, ref)
    assert got["loss"] < 1e-5 and got["grad_norm_gap"] < 1e-4 and got["change_norm_gap"] < 1e-4, got
    assert set(prog["grad"]) == set(ref["grad"]) == {".".join(p) for p, _ in weights.flat(tr.params)}


def test_the_chunked_wkv_is_the_recurrence():
    g = torch.Generator().manual_seed(3)
    bh, s, n = 3, 75, 8  # s not a multiple of the chunk: padding adds nothing
    r, k, v = (torch.randn(bh, s, n, generator=g, dtype=torch.float64) for _ in range(3))
    lw = -torch.exp(torch.randn(bh, s, n, generator=g, dtype=torch.float64) - 1)
    u = torch.randn(bh, n, generator=g, dtype=torch.float64)
    state = torch.zeros(bh, n, n, dtype=torch.float64)
    want = []
    for t in range(s):
        kv = k[:, t, :, None] * v[:, t, None, :]
        want.append(torch.einsum("bn,bnm->bm", r[:, t], state + u[..., None] * kv))
        state = torch.exp(lw[:, t])[..., None] * state + kv
    o, last = ref_rwkv6.wkv(r, k, v, lw, u)
    assert torch.allclose(o, torch.stack(want, 1), atol=1e-10)
    assert torch.allclose(last, state, atol=1e-10)


def _model(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]


def test_model_flops_by_hand():
    m = _model("internlm2-1.8b")
    # q 2048·2048, k and v 2048·1024 each, o 2048·2048, three MLP matrices 2048·8192: 62,914,560
    # a layer, 24 layers; the head 2048·92,544
    n = 24 * 62_914_560 + 2048 * 92_544
    assert flops.body_weights(m) + flops.head_weights(m) == n == 1_699_479_552
    # 6·N·D at 8 x 4096 tokens: 3.3413e14 (3.3415e14 where the norms' 98,304 scales count too)
    assert 6 * n * 8 * 4096 == pytest.approx(3.3413e14, rel=1e-4)
    # attention: 4 · 128 FLOP x 16 heads x 4096·4097/2 pairs x 8 rows x 24 layers, three times
    attn = 3 * 4 * 128 * 16 * (4096 * 4097 // 2) * 8 * 24
    assert flops.train_step_flops(m, 8, 4096) == 6 * n * 8 * 4096 + attn
    r = _model("rwkv6-3b")
    # 5·2560² + 2·2560·64 + 2·2560·8960 + 2560² a layer, 32 layers, head 2560·65,536
    assert flops.body_weights(r) == 32 * (6 * 2560**2 + 2 * 2560 * 64 + 2 * 2560 * 8960)
    assert flops.prefill_flops(r, 100) == 2 * flops.body_weights(r) * 100 + 2 * 2560 * 65_536


def test_kernel_bounds_by_hand():
    # the flash forward at the training microbatch (BHq 32, BHkv 16, S 4096, Dh 128): 1.3748e11
    # FLOP at 989 TFLOP/s
    assert flops.flash_fwd_ms(32, 16, 4096, 128, with_lse=True) == pytest.approx(0.1390, abs=5e-5)
    # its backward, 10·Dh a pair
    assert flops.flash_bwd_ms(32, 16, 4096, 128) == pytest.approx(0.3475, abs=5e-5)
    # WKV6 backward at BH 40, S 4096, N 64: 251.7 MB at 3.35 TB/s
    assert flops.wkv6_bwd_ms(40, 4096, 64) == pytest.approx(251.66e6 / 3.35e12 * 1e3, rel=1e-3)
    # WKV6 forward at BH 160, S 2048, N 64 without an initial state: 296.3 MB
    assert flops.wkv6_fwd_ms(160, 2048, 64, False) == pytest.approx(296.26e6 / 3.35e12 * 1e3,
                                                                     rel=1e-3)
