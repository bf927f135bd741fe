"""The comparison fails what it must: a whole run at tiny size on the CPU,
the look for a card skipped, with the timed path broken underneath, comes
out not correct, once for each fault a cell can have. The cells run one
card, so no exchange between chips exists to leave out. And the control,
the reference computed in fp8 in the program's place, fails the cell's
limits: here at a size a test run holds, and, marked ``cuda``, at the
cell's own size on the card (``calibrate.py`` gives its readings)."""
from __future__ import annotations

import pytest
import torch
from conftest import tiny_cell

import run as bench
from pbench import harness, traffic, weights
from pbench.drivers import prefill, train

TRAIN = ("internlm2-1.8b.train_4k", "rwkv6-3b.train_4k")
PREFILL = ("internlm2-1.8b.prefill_2k-32k", "rwkv6-3b.prefill_2k-32k")


def _run(name):
    return bench.run(name, 21, 0.05, False, device="cpu", cell=tiny_cell(name, dtype="float32"))


@pytest.mark.parametrize("name", TRAIN + PREFILL)
def test_a_sound_tiny_run_is_correct(name):
    assert _run(name)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_fails(name, monkeypatch):
    from repro_torch.launch import steps

    monkeypatch.setattr(steps, "adamw_update",
                        lambda params, grads, state, lr: (params, state,
                                                          {"grad_norm": torch.zeros(())}))
    r = _run(name)
    assert not r["correct"] and r["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out_fails(name, monkeypatch):
    from repro_torch.launch import steps

    whole = steps.accumulate_grads

    def half(cfg, params, batch, *, microbatches=1, dp_group=None):
        n = next(iter(batch.values())).shape[0] // 2
        part = {k: v[:n] for k, v in batch.items()}
        return whole(cfg, params, part, microbatches=min(microbatches, n), dp_group=dp_group)

    monkeypatch.setattr(steps, "accumulate_grads", half)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_an_update_altered_where_it_is_produced_fails(name, monkeypatch):
    """The output head moved double by AdamW: its change reads 1 where its
    change is at least the median leaf's, as the head's is."""
    from repro_torch.launch import steps

    whole = steps.adamw_update

    def doubled(params, grads, state, lr):
        before = params["unembed"].clone()
        params, state, metrics = whole(params, grads, state, lr=lr)
        params["unembed"].mul_(2.0).sub_(before)
        return params, state, metrics

    monkeypatch.setattr(steps, "adamw_update", doubled)
    r = _run(name)
    assert not r["correct"] and r["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0, rel=1e-3)


@pytest.mark.parametrize("name", TRAIN)
def test_a_key_gradient_altered_where_it_is_produced_fails(name):
    """The attention or WKV6 kernel's gradient for its keys doubled: AdamW's
    first step moves by the gradient's signs alone, so the change cannot see
    it, and the gradient's norms must."""
    import calibrate

    with calibrate.key_gradient_doubled():
        r = _run(name)
    over = [k for k, c in r["checks"].items() if k.startswith("grad_norm") and c["value"] > c["limit"]]
    assert not r["correct"] and over, r["checks"]


def _broken_prefill(monkeypatch, alter):
    from repro_torch.launch import steps

    whole = steps.make_prefill_step
    monkeypatch.setattr(steps, "make_prefill_step", lambda cfg: (lambda p, b: alter(*whole(cfg)(p, b))))


@pytest.mark.parametrize("name", PREFILL)
def test_a_served_token_altered_where_it_is_produced_fails(name, monkeypatch):
    def alter(logits, cache):
        logits = logits.clone()
        best = int(logits[0, -1].argmax())
        logits[0, -1, best] = logits[0, -1].min() - 1  # the next-best token is served
        return logits, cache

    _broken_prefill(monkeypatch, alter)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", PREFILL)
def test_a_prefill_that_leaves_the_state_unchanged_fails(name, monkeypatch):
    _broken_prefill(monkeypatch, lambda logits, cache: (
        logits, {k: torch.zeros_like(v) for k, v in cache.items()}))
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_the_training_control_fails(name):
    cell = tiny_cell(name)
    ref = train.reference_steps(cell, 31, "cpu")
    control = train.compare(train.reference_steps(cell, 31, "cpu", quant="fp8"), ref)
    assert not harness.judge(control, cell.limits)[0], control


@pytest.mark.parametrize("name", PREFILL)
def test_the_prefill_control_fails(name):
    cell = tiny_cell(name)
    m = cell.model
    W = weights.make(harness.reference(cell).leaves(m), 31, "cpu")
    reqs = traffic.prompts(cell.traffic, m["vocab_size"], 31, "cpu")
    picked = list(range(len(reqs)))
    kept = {}
    for i in picked:
        logits, layers = prefill.reference_outputs(cell, W, reqs[i][1], quant="fp8")
        cache = {k: torch.stack([layers[j][k] for j in sorted(layers)]) for k in layers[0]}
        kept[i] = (logits, cache, int(logits.argmax()))
    control = prefill.check(cell, 31, "cpu", reqs, picked, kept)
    assert not harness.judge(control, cell.limits)[0], control


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN + PREFILL)
def test_the_control_fails_at_the_cells_size(name, cuda):
    import calibrate

    cell = harness.load_cell(name)
    per_seed = calibrate.train_seed if cell.traffic["kind"] == "train" else calibrate.prefill_seed
    for seed in (101, 102, 103):
        out = per_seed(cell, seed, True)
        assert harness.judge(out["program"], cell.limits)[0], out["program"]
        assert not harness.judge(out["control"], cell.limits)[0], out["control"]
