"""Data-parallel training over two gloo ranks, on the CPU.

Two subprocesses run ``Trainer`` with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) on reduced
internlm2-1.8b, each on its half of every global batch, under
``torch.profiler`` with ``record_shapes=True``. After two steps both ranks'
parameters are within 1e-6 of a one-process ``Trainer`` on the whole batch
(its two microbatches the ranks' halves), and within
``tests/test_torch_train.py``'s tolerance (1e-4, ‖Δ‖₂/‖p‖₂ a leaf) of
``repro``'s Trainer from the same weights. The collectives reader
(``analysis.hlo.parse_collectives``) finds one fp32 all-reduce a leaf a
step, whose bytes are the gradients' bytes; only rank 0 writes a
checkpoint. Each rank has a timeout of its own, so a hang fails the test.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.optim import adamw_init as ref_adamw_init
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro_torch import configs
from repro_torch.models import schema
from repro_torch.train import Trainer, TrainerConfig
from test_torch_train import GRAD_TOL, grad_errors

SRC = Path(__file__).resolve().parents[1] / "src"
RANK_TIMEOUT = 120
TC = dict(steps=2, batch_size=4, seq_len=16, warmup=1, peak_lr=1e-3, log_every=100, seed=3)
CFG = dict(arch="internlm2-1.8b", dtype="float32")

RANK_CODE = """
import json, os, sys
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile
from repro_torch import configs
from repro_torch.analysis.hlo import parse_collectives
from repro_torch.models.schema import leaf_paths
from repro_torch.train import Trainer, TrainerConfig

out, cfg_kw, tc_kw = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
cfg = configs.reduced(configs.get_config(cfg_kw["arch"]), dtype=cfg_kw["dtype"])
rank = int(os.environ["RANK"])
tc = TrainerConfig(**tc_kw, ckpt_dir=f"{out}/ck{rank}", ckpt_every=1)
tr = Trainer(cfg, tc, verbose=False, device="cpu")
with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
    hist = tr.run()
stats = parse_collectives(prof).as_dict()
leaves = [p for _, p in leaf_paths(tr.params)]
torch.save({k: v for k, v in leaf_paths(tr.params)}, f"{out}/params{rank}.pt")
json.dump({"rank": tr.rank, "world": tr.world, "stats": stats, "history": hist,
           "grad_bytes": sum(p.numel() * p.element_size() for p in leaves),
           "n_leaves": len(leaves), "dtypes": sorted({str(p.dtype) for p in leaves})},
          open(f"{out}/rank{rank}.json", "w"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(out: Path, world: int = 2) -> None:
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), PYTHONPATH=str(SRC))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CODE, str(out), json.dumps(CFG), json.dumps(TC)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for rank, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {rank} did not finish in {RANK_TIMEOUT} s")
        if p.returncode:
            errors.append(f"rank {rank} exited {p.returncode}:\n{err[-3000:]}")
    assert not errors, "\n".join(errors)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The output directory of one two-rank run."""
    out = tmp_path_factory.mktemp("dp")
    _run_ranks(out)
    return out


def test_two_gloo_ranks_train_as_one_process(dp_run):
    tmp_path = dp_run
    cfg = configs.reduced(configs.get_config(CFG["arch"]), dtype=CFG["dtype"])
    solo = Trainer(cfg, TrainerConfig(**TC, microbatches=2), verbose=False, device="cpu")
    solo.run()
    assert solo.mesh is None and solo.world == 1  # one process creates no group
    want = dict(schema.leaf_paths(solo.params))
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    for r, info in enumerate(ranks):
        assert (info["rank"], info["world"]) == (r, 2)
        got = torch.load(tmp_path / f"params{r}.pt")
        assert sorted(got) == sorted(want)
        worst = max(float((got[k] - want[k]).abs().max()) for k in want)
        assert worst <= 1e-6, (r, worst)
        # one fp32 all-reduce a leaf a step, of the gradients' bytes
        stats = info["stats"]
        assert info["dtypes"] == ["torch.float32"]
        assert stats["by_op_bytes"] == {"all-reduce": TC["steps"] * info["grad_bytes"]}
        assert stats["by_op_count"] == {"all-reduce": TC["steps"] * info["n_leaves"]}
        assert stats["total_bytes"] == TC["steps"] * info["grad_bytes"]
    # the ranks' losses are their own halves'; their mean is the whole batch's
    for step, h in enumerate(solo.history):
        mean = (ranks[0]["history"][step]["loss"] + ranks[1]["history"][step]["loss"]) / 2
        assert abs(mean - h["loss"]) <= 1e-5 * abs(h["loss"])
        for r in ranks:
            assert abs(r["history"][step]["grad_norm"] - h["grad_norm"]) <= 1e-5 * h["grad_norm"]
    # only rank 0 writes checkpoints
    assert sorted(p.name for p in (tmp_path / "ck0").iterdir())
    assert not (tmp_path / "ck1").exists() or not any((tmp_path / "ck1").iterdir())


def test_two_gloo_ranks_match_the_references_trainer(dp_run):
    tmp_path = dp_run
    cfg = configs.reduced(configs.get_config(CFG["arch"]), dtype=CFG["dtype"])
    ref_cfg = ref_configs.reduced(ref_configs.get_config(CFG["arch"]), dtype=CFG["dtype"])
    init = Trainer(cfg, TrainerConfig(**TC), verbose=False, device="cpu").params
    ref = RefTrainer(ref_cfg, RefTrainerConfig(**TC, microbatches=2), verbose=False)
    ref.params = jax.tree.map(jnp.asarray, schema.map_tree(init, lambda t: t.numpy().copy()))
    ref.opt_state = ref_adamw_init(ref.params)
    ref.run()
    want = jax.tree.map(np.asarray, ref.params)
    for r in range(2):
        flat = torch.load(tmp_path / f"params{r}.pt")
        got = {}
        for path, v in flat.items():
            schema.set_path(got, path, v)
        errs = grad_errors(got, want)
        assert max(errs.values()) < GRAD_TOL, (r, errs)


def test_one_process_trainer_keeps_its_path(monkeypatch, tmp_path):
    """Without torchrun's environment nothing distributed runs, and a
    world of one in it creates no group either."""
    import torch.distributed as dist

    cfg = dataclasses.replace(configs.reduced(configs.get_config(CFG["arch"])), dtype="float32")
    for env in ({}, {"RANK": "0", "WORLD_SIZE": "1"}):
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        tr = Trainer(cfg, TrainerConfig(steps=1, batch_size=2, seq_len=8, log_every=100,
                                        ckpt_dir=str(tmp_path), ckpt_every=1),
                     verbose=False, device="cpu")
        tr.run()
        assert tr.mesh is None and (tr.rank, tr.world) == (0, 1)
        assert tr.ckpt is not None and not dist.is_initialized()


class _Event:
    """A ``FunctionEvent``'s fields that the collectives reader reads."""

    def __init__(self, name, shapes, dtypes, start, end):
        from torch.autograd import DeviceType

        self.name, self.input_shapes, self.input_dtypes = name, shapes, dtypes
        self.device_type = DeviceType.CPU
        self.time_range = type("Interval", (), {"start": start, "end": end})()


def test_collectives_reader_counts_backend_events_once():
    """Each collective counts once, from its backend event (the ``c10d::``
    op around it has no shapes), by the reference's op names; a backend
    event without a dtype is refused."""
    from repro_torch.analysis.hlo import parse_collectives

    events = [
        _Event("c10d::allreduce_", [[], []], ["TensorList", ""], 0, 100),
        _Event("nccl:all_reduce", [[8, 4]], ["float"], 2, 80),
        _Event("c10d::_allgather_base_", [[32], [16]], ["c10::BFloat16"] * 2, 101, 120),
        _Event("nccl:_allgather_base", [[16]], ["c10::BFloat16"], 102, 110),
        _Event("gloo:all_reduce", [[3]], ["double"], 130, 131),
    ]
    stats = parse_collectives(events).as_dict()
    assert stats == {"total_bytes": 8 * 4 * 4 + 16 * 2 + 3 * 8,
                     "by_op_bytes": {"all-reduce": 8 * 4 * 4 + 3 * 8, "all-gather": 32},
                     "by_op_count": {"all-reduce": 2, "all-gather": 1}}
    with pytest.raises(ValueError, match="record_shapes"):
        parse_collectives([_Event("nccl:all_reduce", [[8, 4]], [], 2, 80)])
