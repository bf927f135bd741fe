"""The port's training path against ``repro``'s, on the CPU: ``loss_fn``
and every gradient leaf for each architecture (rwkv6's through the plain
chunked WKV6, which autograd differentiates here), remat, the train
step with microbatches, ``Trainer`` (steps, resume, the lease guard) and
the lease-coordinated failover story of ``tests/test_system.py``.

Weights are the port's ``init_model`` (its own generator), with every leaf
the schema starts at zeros or ones moved off it by numpy noise, handed to
both packages as numpy arrays; batches come from numpy. Limits: the loss
and ``ce`` to 1e-5 relative, ``aux`` to 1e-5 absolute, and each gradient
leaf to ‖Δ‖₂/‖g‖₂ < 1e-4 in fp32 (two frameworks' fp32 sums in another
order through a few layers read ~1e-6). In bf16 compute (fp32 master
weights) each leaf to 5e-2: bf16 keeps 8 bits (3.9e-3 a rounding), and the
two packages round the activations at other places (internlm2 reads
~1e-2, rwkv6 ~2e-2). ``Trainer`` losses to 2e-4 relative over 3 steps.

The reference's ``moe_dispatch`` warns (``DeprecationWarning``; ``ROADMAP.md``,
reference fault 4), which ``pytest.ini`` turns into an error; every call of
the reference on an MoE config runs under ``ref_warnings_off``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_transformer
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models import carry, init_model, loss_fn, schema, transformer
from repro_torch.train import Trainer, TrainerConfig
from test_torch_moe import ref_warnings_off

ARCHS = configs.arch_ids()
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_GRAD_TOL = 5e-2
TRAINER_TOL = 2e-4


def cfg_pair(name, dtype="float32", **changes):
    """The port's and the reference's reduced config of ``name``."""
    return tuple(dataclasses.replace(pkg.reduced(pkg.get_config(name), dtype=dtype), **changes)
                 for pkg in (configs, ref_configs))


def weights(cfg, seed=0) -> dict:
    """Numpy weights: the port's init, zeros and ones moved off by noise."""
    tree = init_model(cfg, seed, device="cpu")
    tree = schema.map_tree(tree, lambda t: t.numpy().copy())
    rng = np.random.default_rng(seed)
    for path, p in schema.leaf_paths(transformer.model_schema(cfg)):
        if p.init in ("zeros", "ones"):
            node = tree
            for key in path[:-1]:
                node = node[key]
            base = 1.0 if p.init == "ones" else 0.0
            node[path[-1]] = (base + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
    return tree


def make_batch(cfg, b=2, s=16, seed=0) -> dict:
    """tokens and labels (some masked at -1), and the family's frames or
    patch embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(-1, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal((b, 5, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal((b, 24, cfg.d_model)).astype(np.float32)
    return batch


def ref_value_and_grad(ref_cfg, tree, batch):
    """The reference's (loss, metrics), grads as numpy."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_transformer.loss_fn(ref_cfg, p, b), has_aux=True))
    with ref_warnings_off():
        (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, tree),
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads)


def port_value_and_grad(cfg, tree, batch, **kw):
    params = carry.params_from_reference(cfg, tree, device="cpu")
    grads, loss, metrics = steps.accumulate_grads(cfg, params, batch, **kw)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def grad_errors(got: dict, want: dict) -> dict:
    """‖Δ‖₂/‖g‖₂ of every leaf, by its '/'-joined path."""
    want = dict(schema.leaf_paths(want))
    out = {}
    for path, g in schema.leaf_paths(got):
        w = np.asarray(want[path], np.float64)
        d = np.asarray(g.float().numpy(), np.float64) - w
        out["/".join(path)] = float(np.linalg.norm(d) / max(np.linalg.norm(w), 1e-30))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match(arch):
    cfg, ref_cfg = cfg_pair(arch)
    tree, batch = weights(cfg), make_batch(cfg)
    want_loss, want_m, want_g = ref_value_and_grad(ref_cfg, tree, batch)
    loss, m, grads = port_value_and_grad(cfg, tree, batch)
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
    assert abs(m["ce"] - want_m["ce"]) <= LOSS_TOL * abs(want_m["ce"])
    assert abs(m["aux"] - want_m["aux"]) <= LOSS_TOL
    assert m["tokens"] == want_m["tokens"] == float((batch["labels"] >= 0).sum())
    if cfg.moe is not None:
        assert m["aux"] > 0  # the layers' load-balance losses reach the loss
    errs = grad_errors(grads, want_g)
    assert len(errs) == len(list(schema.leaf_paths(transformer.model_schema(cfg))))
    bad = {k: e for k, e in errs.items() if not e < GRAD_TOL}
    assert not bad, bad


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-3b"])
def test_bf16_compute_gradients_match(arch):
    cfg, ref_cfg = cfg_pair(arch, dtype="bfloat16")
    tree, batch = weights(cfg, seed=3), make_batch(cfg, seed=3)
    want_loss, _, want_g = ref_value_and_grad(ref_cfg, tree, batch)
    loss, _, grads = port_value_and_grad(cfg, tree, batch)
    assert abs(loss - want_loss) <= 1e-2 * abs(want_loss)
    bad = {k: e for k, e in grad_errors(grads, want_g).items() if not e < BF16_GRAD_TOL}
    assert not bad, bad


def test_vision_logits_start_after_the_patches():
    """Position P - 1 + j predicts text token j: the loss is the cross
    entropy of exactly those logits."""
    cfg, _ = cfg_pair("internvl2-2b")
    tree, batch = weights(cfg), make_batch(cfg, b=1, s=6)
    params = carry.params_from_reference(cfg, tree, device="cpu")
    bt = steps.batch_to(batch, "cpu")
    with torch.no_grad():
        logits, _ = transformer.forward(cfg, params, bt)
        loss, m = loss_fn(cfg, params, bt)
    p_len = batch["patch_embeds"].shape[1]
    text = logits[:, p_len - 1:p_len - 1 + 6].float()
    lab = bt["labels"].long()
    keep = lab >= 0
    ce = torch.logsumexp(text, -1) - text.gather(-1, lab.clamp_min(0)[..., None])[..., 0]
    assert logits.shape[1] == p_len + 6
    assert torch.allclose(loss, (ce * keep).sum() / keep.sum(), rtol=1e-6)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x22b"])
@pytest.mark.parametrize("policy", ["nothing", "full", "dots"])
def test_each_remat_policy_equals_none(arch, policy):
    cfg, _ = cfg_pair(arch, remat_policy=policy)
    tree, batch = weights(cfg, seed=1), make_batch(cfg, seed=1)
    params = carry.params_from_reference(cfg, tree, device="cpu")
    bt = steps.batch_to(batch, "cpu")
    outs = []
    for remat in (False, True):
        for p in schema.leaf_paths(params):
            p[1].requires_grad_(True)
            p[1].grad = None
        loss, _ = loss_fn(cfg, params, bt, remat=remat)
        loss.backward()
        outs.append((loss.detach(), {k: g.grad.clone() for k, g in schema.leaf_paths(params)}))
    (l0, g0), (l1, g1) = outs
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.allclose(g0[k], g1[k], rtol=1e-6, atol=1e-9), k


def test_rwkv6_loss_runs_on_the_cpu():
    """On the CPU autograd differentiates the plain chunked WKV6 (on the
    card the WKV6 kernels take its place, forward and backward): the loss
    and every gradient leaf are finite. Parity with the reference is
    ``test_loss_and_every_gradient_leaf_match``'s."""
    cfg, _ = cfg_pair("rwkv6-3b")
    params = carry.params_from_reference(cfg, weights(cfg), device="cpu")
    grads, loss, _ = steps.accumulate_grads(cfg, params, make_batch(cfg))
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(g).all() for _, g in schema.leaf_paths(grads))


def test_train_step_matches_the_references():
    """One ``make_train_step`` (two microbatches) from carried weights and
    moments against the reference's: metrics and every updated leaf."""
    from repro.launch.steps import make_train_step as ref_make_train_step
    from repro.optim import adamw_init as ref_adamw_init

    cfg, ref_cfg = cfg_pair("qwen1.5-0.5b")
    tree, batch = weights(cfg, seed=4), make_batch(cfg, b=4, seed=4)
    ref_params = jax.tree.map(jnp.asarray, tree)
    ref_opt = ref_adamw_init(ref_params)
    kw = dict(peak_lr=1e-3, warmup=2, total=10, microbatches=2)
    rp, ro, rm = jax.jit(ref_make_train_step(ref_cfg, **kw))(
        ref_params, ref_opt, {k: jnp.asarray(v) for k, v in batch.items()})
    params = carry.params_from_reference(cfg, tree, device="cpu")
    opt = carry.opt_state_from_reference(cfg, jax.tree.map(np.asarray, ref_opt), device="cpu")
    params, opt, m = steps.make_train_step(cfg, **kw)(params, opt, batch)
    assert sorted(m) == sorted(rm)
    for k in rm:
        assert abs(float(m[k]) - float(rm[k])) <= 1e-5 * max(1.0, abs(float(rm[k]))), k
    assert int(opt["step"]) == int(ro["step"]) == 1
    for name, got, want in (("params", params, rp), ("m", opt["m"], ro["m"]),
                            ("v", opt["v"], ro["v"])):
        errs = grad_errors(got, jax.tree.map(np.asarray, want))
        assert max(errs.values()) < 1e-4, (name, errs)


TINY = dataclasses.replace(configs.reduced(configs.get_config("qwen1.5-0.5b")),
                           name="tiny", vocab_size=128, dtype="float32")
REF_TINY = dataclasses.replace(ref_configs.reduced(ref_configs.get_config("qwen1.5-0.5b")),
                               name="tiny", vocab_size=128, dtype="float32")


def carried_trainer(tc, ref_tc=None, **kw):
    """A reference ``Trainer`` and the port's with its weights and state."""
    ref = RefTrainer(REF_TINY, ref_tc or RefTrainerConfig(**dataclasses.asdict(tc)), verbose=False)
    port = Trainer(TINY, tc, verbose=False, device="cpu", **kw)
    port.params = carry.params_from_reference(TINY, jax.tree.map(np.asarray, ref.params),
                                              device="cpu")
    port.opt_state = carry.opt_state_from_reference(
        TINY, jax.tree.map(np.asarray, ref.opt_state), device="cpu")
    return ref, port


def test_trainer_three_steps_give_the_references_losses():
    tc = TrainerConfig(steps=3, batch_size=4, seq_len=32, warmup=1, peak_lr=1e-3,
                       log_every=100, seed=2)
    ref, port = carried_trainer(tc)
    want, got = ref.run(), port.run()
    assert [h["step"] for h in got] == [1, 2, 3]
    for g, w in zip(got, want):
        for key in ("loss", "lr", "grad_norm"):
            assert abs(g[key] - w[key]) <= TRAINER_TOL * abs(w[key]), (key, g, w)
    assert got[-1]["loss"] != got[0]["loss"]  # the weights moved


def test_microbatch_accumulation_matches_full_batch():
    """As the reference's test: same data and init, four microbatches
    against one, the updated weights within 2e-4."""
    tc1 = TrainerConfig(steps=1, batch_size=8, seq_len=32, microbatches=1, seed=5)
    tc2 = dataclasses.replace(tc1, microbatches=4)
    t1 = Trainer(TINY, tc1, verbose=False, device="cpu")
    t2 = Trainer(TINY, tc2, verbose=False, device="cpu")
    t1.run()
    t2.run()
    diffs = [float((a - b).abs().max()) for (_, a), (_, b)
             in zip(schema.leaf_paths(t1.params), schema.leaf_paths(t2.params))]
    assert max(diffs) < 2e-4


def test_trainer_runs_and_checkpoints(tmp_path):
    tc = TrainerConfig(steps=4, batch_size=4, seq_len=32, ckpt_dir=str(tmp_path),
                       ckpt_every=2, log_every=100)
    tr = Trainer(TINY, tc, verbose=False, device="cpu")
    hist = tr.run()
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    assert tr.ckpt.saved_steps == [2, 4]


def test_trainer_resume_continues_not_restarts(tmp_path):
    tc = TrainerConfig(steps=3, batch_size=4, seq_len=32, ckpt_dir=str(tmp_path),
                       ckpt_every=3, log_every=100)
    first = Trainer(TINY, tc, verbose=False, device="cpu")
    first.run()
    tr2 = Trainer(TINY, dataclasses.replace(tc, steps=5), verbose=False, device="cpu")
    assert tr2.step == 3  # resumed, not restarted
    for (_, a), (_, b) in zip(schema.leaf_paths(first.params), schema.leaf_paths(tr2.params)):
        assert torch.equal(a, b)
    assert int(tr2.opt_state["step"]) == 3
    assert tr2.run()[-1]["step"] == 5


def test_lease_guard_blocks_checkpoints(tmp_path):
    tc = TrainerConfig(steps=4, batch_size=2, seq_len=16, ckpt_dir=str(tmp_path),
                       ckpt_every=1, log_every=100)
    tr = Trainer(TINY, tc, lease_guard=lambda: False, verbose=False, device="cpu")
    tr.run()
    assert tr.ckpt.saved_steps == []
    assert tr.ckpt.skipped_no_lease == 4


def test_async_checkpoints_hold_each_steps_state(tmp_path):
    """The async writer gets host copies: what it writes for a step is that
    step's state even though the next steps update the tensors in place."""
    from repro_torch.checkpoint import restore_checkpoint

    tc = TrainerConfig(steps=3, batch_size=2, seq_len=16, ckpt_dir=str(tmp_path),
                       ckpt_every=3, ckpt_async=True, log_every=100)
    tr = Trainer(TINY, tc, verbose=False, device="cpu")
    tr.run()
    assert tr.async_ckpt.saved_steps == [3] and not tr.async_ckpt.errors
    state, step = restore_checkpoint(tmp_path)
    assert step == 3
    for path, p in schema.leaf_paths(tr.params):
        node = state["params"]
        for key in path:
            node = node[key]
        assert np.array_equal(node, p.numpy())


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TINY, TrainerConfig(steps=1), verbose=False)


def test_train_cli_runs_on_the_cpu(tmp_path):
    hist = train_cli.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "2",
                           "--batch-size", "2", "--seq-len", "16", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert (tmp_path / "step_00000002" / "manifest.json").exists()


def test_lease_coordinated_training_with_failover(tmp_path):
    """``tests/test_system.py``'s story on the port's cluster and trainer: the
    control plane elects a checkpoint writer; training checkpoints only
    under the lease; when the writer dies another node takes over and
    training resumes from its checkpoint."""
    from repro_torch.cluster.coordinator import CKPT_RESOURCE, build_coordinated_cluster
    from repro_torch.configs.paxoslease_cell import CellConfig
    from repro_torch.sim.network import NetConfig

    net = NetConfig(delay_min=0.005, delay_max=0.05, loss=0.05)
    cell_cfg = CellConfig(n_acceptors=3, max_lease_time=30.0, lease_timespan=5.0,
                          backoff_min=0.1, backoff_max=0.5)
    cell, _ = build_coordinated_cluster(cell_cfg, n_workers=0, seed=0, net=net)
    n0, n1 = cell.proposers[0], cell.proposers[1]
    for n in (n0, n1):
        n.proposer.acquire(CKPT_RESOURCE, timespan=5.0, renew=True)
    cell.env.run_until(3.0)
    holder = cell.monitor.owner_of(CKPT_RESOURCE)
    assert holder in (0, 1)
    holder_node = cell.nodes[holder]
    other_node = n1 if holder == 0 else n0

    tc = TrainerConfig(steps=4, batch_size=2, seq_len=16, ckpt_dir=str(tmp_path),
                       ckpt_every=2, log_every=100)
    tr1 = Trainer(TINY, tc, lease_guard=lambda: holder_node.proposer.is_owner(CKPT_RESOURCE),
                  verbose=False, device="cpu")
    tr1.run()
    assert tr1.ckpt.saved_steps == [2, 4]

    holder_node.crash()
    deadline = cell.env.now + cell_cfg.lease_timespan + 10.0
    while cell.env.now < deadline and not other_node.proposer.is_owner(CKPT_RESOURCE):
        cell.env.run_until(cell.env.now + 0.5)
    assert other_node.proposer.is_owner(CKPT_RESOURCE)
    cell.monitor.assert_clean()

    tr2 = Trainer(TINY, dataclasses.replace(tc, steps=6),
                  lease_guard=lambda: other_node.proposer.is_owner(CKPT_RESOURCE),
                  verbose=False, device="cpu")
    assert tr2.step == 4  # resumed where the dead writer left off
    tr2.run()
    assert 6 in tr2.ckpt.saved_steps
