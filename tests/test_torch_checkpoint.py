"""The port's checkpoints against ``repro``'s format, on the CPU: written by
either package and read by the other (fp32, int32 and bf16 leaves),
retention, no temporary directory left behind, the writer's cadence and
lease guard, the async writer, and a ``Trainer`` of either package resuming
from the other's checkpoint.

The reference writes a bf16 leaf as its raw two-byte values (numpy
``|V2``, ``"bfloat16"`` in the manifest); the port writes the same bytes
and reads them back as a bf16 tensor.
"""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro import configs as ref_configs
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.models import schema
from repro_torch.train import Trainer, TrainerConfig


def state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"embed": rng.standard_normal((7, 4)).astype(np.float32),
                   "layers": {"w": rng.standard_normal((2, 4, 3)).astype(np.float32)}},
        "opt": {"m": {"w": rng.standard_normal((2, 4, 3)).astype(np.float32)},
                "step": np.int32(5)},
    }


def as_torch(tree):
    return schema.map_tree(tree, lambda v: torch.from_numpy(np.array(v)))


def manifest(path):
    m = json.loads((path / "manifest.json").read_text())
    m.pop("time")
    return m


def test_port_writes_what_the_reference_reads(tmp_path):
    s = state()
    final = ckpt.save_checkpoint(tmp_path / "port", 5, as_torch(s))
    ref_final = ref_ckpt.save_checkpoint(tmp_path / "ref", 5, jax.tree.map(jnp.asarray, s))
    assert manifest(final) == manifest(ref_final)
    got, step = ref_ckpt.restore_checkpoint(tmp_path / "port")
    assert step == 5
    for (path, g), (_, w) in zip(schema.leaf_paths(got), schema.leaf_paths(s)):
        assert g.dtype == w.dtype and np.array_equal(g, w), path


def test_reference_writes_what_the_port_reads(tmp_path):
    s = state(1)
    ref_ckpt.save_checkpoint(tmp_path, 9, jax.tree.map(jnp.asarray, s))
    got, step = ckpt.restore_checkpoint(tmp_path)
    assert step == 9
    for (path, g), (_, w) in zip(schema.leaf_paths(got), schema.leaf_paths(s)):
        assert g.dtype == w.dtype and np.array_equal(g, w), path
    on_device, _ = ckpt.restore_checkpoint(tmp_path, device="cpu")
    assert all(isinstance(t, torch.Tensor) for _, t in schema.leaf_paths(on_device))


def test_bf16_leaves_are_written_as_the_reference_writes_them(tmp_path):
    values = np.array([0.0, 1.0, -2.5, 3.140625, 1e-3], np.float32)
    ref_final = ref_ckpt.save_checkpoint(tmp_path / "ref", 1, {"m": jnp.asarray(values, jnp.bfloat16)})
    final = ckpt.save_checkpoint(tmp_path / "port", 1, {"m": torch.from_numpy(values).bfloat16()})
    assert manifest(final) == manifest(ref_final)
    with np.load(final / "arrays.npz") as a, np.load(ref_final / "arrays.npz") as b:
        assert a["m"].dtype == b["m"].dtype and a["m"].tobytes() == b["m"].tobytes()
    for d in ("ref", "port"):
        got, _ = ckpt.restore_checkpoint(tmp_path / d)
        assert got["m"].dtype == torch.bfloat16
        assert torch.equal(got["m"], torch.from_numpy(values).bfloat16())


def test_retention_keeps_the_newest(tmp_path):
    for step in range(1, 6):
        ckpt.save_checkpoint(tmp_path, step, as_torch(state(step)), keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(tmp_path) == 5


def test_no_tmp_left_behind_even_on_failure(tmp_path):
    ckpt.save_checkpoint(tmp_path, 1, as_torch(state()))
    assert not list(tmp_path.glob(".tmp_*"))

    class Broken:
        def __array__(self, *a, **k):
            raise RuntimeError("disk on fire")

    with pytest.raises(RuntimeError):
        ckpt.save_checkpoint(tmp_path, 2, {"x": Broken()})
    with pytest.raises(Exception):
        ckpt.save_checkpoint(tmp_path, 3, {"x": np.zeros(3), "y": {"z": Broken()}})
    assert not list(tmp_path.glob(".tmp_*"))
    assert ckpt.latest_step(tmp_path) == 1


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path)


def test_manager_cadence_and_lease_guard(tmp_path):
    held = {"lease": True}
    mgr = ckpt.CheckpointManager(str(tmp_path), every_steps=2,
                                 lease_guard=lambda: held["lease"])
    calls = []

    def snap():
        calls.append(1)
        return as_torch(state())

    assert not mgr.maybe_save(1, snap)
    assert mgr.maybe_save(2, snap)
    held["lease"] = False
    assert not mgr.maybe_save(4, snap)
    assert mgr.saved_steps == [2] and mgr.skipped_no_lease == 1
    assert len(calls) == 1  # no snapshot without a save
    assert mgr.restore_latest()[1] == 2


def test_async_checkpointer_writes_and_flushes(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep=5)
    for step in (1, 2, 3):
        assert w.submit(step, as_torch(state(step)))
    w.close()
    assert not w.errors
    assert w.saved_steps[-1] == 3  # coalesced to the newest, never lost
    got, step = ckpt.restore_checkpoint(tmp_path)
    assert step == 3 and np.array_equal(got["params"]["embed"], state(3)["params"]["embed"])
    blocked = ckpt.AsyncCheckpointer(str(tmp_path / "b"), lease_guard=lambda: False)
    assert not blocked.submit(1, as_torch(state()))
    blocked.close()
    assert blocked.saved_steps == []


def test_async_close_waits_for_a_slow_write(tmp_path, monkeypatch):
    """A snapshot between the queue and the writer still counts as pending."""
    from repro_torch.checkpoint import manager

    def slow_save(*a, **k):
        time.sleep(0.3)
        return ckpt.save_checkpoint(*a, **k)

    monkeypatch.setattr(manager, "save_checkpoint", slow_save)
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    w.submit(7, as_torch(state()))
    w.close()
    assert w.saved_steps == [7]


TINY = dataclasses.replace(configs.reduced(configs.get_config("qwen1.5-0.5b")),
                           name="tiny", vocab_size=128, dtype="float32")
REF_TINY = dataclasses.replace(ref_configs.reduced(ref_configs.get_config("qwen1.5-0.5b")),
                               name="tiny", vocab_size=128, dtype="float32")


def test_each_trainer_resumes_from_the_others_checkpoint(tmp_path):
    tc = dict(steps=2, batch_size=2, seq_len=16, ckpt_every=2, log_every=100)
    ref = RefTrainer(REF_TINY, RefTrainerConfig(ckpt_dir=str(tmp_path / "a"), **tc),
                     verbose=False)
    ref.run()
    port = Trainer(TINY, TrainerConfig(ckpt_dir=str(tmp_path / "a"), **{**tc, "steps": 3}),
                   verbose=False, device="cpu")
    assert port.step == 2
    want = dict(schema.leaf_paths(jax.tree.map(np.asarray, ref.params)))
    for path, p in schema.leaf_paths(port.params):
        assert np.array_equal(p.numpy(), want[path]), path
    assert int(port.opt_state["step"]) == 2

    port2 = Trainer(TINY, TrainerConfig(ckpt_dir=str(tmp_path / "b"), **tc),
                    verbose=False, device="cpu")
    port2.run()
    ref2 = RefTrainer(REF_TINY, RefTrainerConfig(ckpt_dir=str(tmp_path / "b"), **{**tc, "steps": 3}),
                      verbose=False)
    assert ref2.step == 2
    got = dict(schema.leaf_paths(jax.tree.map(np.asarray, ref2.params)))
    for path, p in schema.leaf_paths(port2.params):
        assert np.array_equal(got[path], p.numpy()), path
    assert int(ref2.opt_state["step"]) == 2
