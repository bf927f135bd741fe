"""The resharding restore (``restore_checkpoint(..., shardings=, mesh=)``,
``CheckpointManager.restore_latest``) over two gloo ranks, on the CPU.

A reduced internlm2-1.8b state (fp32 parameters and AdamW moments, the
int32 step, and one bf16 leaf) is written once by the port's
``save_checkpoint`` and once by ``repro``'s. Two subprocesses with
torchrun's environment build a ``DeviceMesh`` of (data 2, model 1), with the
ZeRO-1 optimizer specs, or of (data 1, model 2), and restore both
directories with the spec trees of ``launch.steps.param_shardings`` and
``opt_shardings``. Each rank checks that every leaf with a spec is a DTensor
whose local shape is ``sharding.local_shape`` of its spec and whose local
shard equals ``distribute_tensor``'s shard of the saved array; that the
leaves without a spec come back as they do without ``shardings``; and that
a spec for a path the checkpoint lacks raises. Rank 0 writes every leaf's
``full_tensor()``, which must equal ``repro.checkpoint.restore_checkpoint``
of the same directory bit for bit. Each rank has a timeout of its own.
"""
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

from repro import checkpoint as ref_ckpt
from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.models import init_model, schema
from repro_torch.optim import adamw_init

SRC = Path(__file__).resolve().parents[1] / "src"
RANK_TIMEOUT = 120
ARCH = "internlm2-1.8b"
#: (mesh shape, zero1) of each two-rank run
MESHES = {"data2_model1": ((2, 1), True), "data1_model2": ((1, 2), False)}
#: a bf16 leaf with a spec, and one leaf left without a spec
BF16_SPEC = ("model",)

RANK_CODE = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
from repro_torch.launch.steps import opt_shardings, param_shardings
from repro_torch.models.schema import leaf_paths
from repro_torch.parallel import sharding as shd

out, ckdirs, shape, zero1, arch = (sys.argv[1], json.loads(sys.argv[2]),
                                   tuple(json.loads(sys.argv[3])), sys.argv[4] == "1", sys.argv[5])
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world)
mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
cfg = configs.reduced(configs.get_config(arch))
rules = shd.make_rules(mesh)
specs = {"params": param_shardings(cfg, mesh, rules),
         "opt": opt_shardings(cfg, mesh, rules, zero1=zero1),
         "extra": {"w_bf16": tuple(json.loads(sys.argv[6]))}}
flat_specs = {"/".join(k): v for k, v in leaf_paths(specs)}
report = {"rank": rank, "coordinate": mesh.get_coordinate(), "sharded_dims": 0}
for name, d in ckdirs.items():
    plain, _ = restore_checkpoint(d)
    if name == "port":
        got, step = CheckpointManager(d).restore_latest(shardings=specs, mesh=mesh)
    else:
        got, step = restore_checkpoint(d, shardings=specs, mesh=mesh)
    assert step == 7, step
    full = {}
    for path, leaf in leaf_paths(got):
        key = "/".join(path)
        want = dict(leaf_paths(plain))[path]
        want = want if isinstance(want, torch.Tensor) else torch.from_numpy(np.asarray(want))
        if key not in flat_specs:  # no spec: as without shardings
            assert not isinstance(leaf, DTensor), key
            assert np.asarray(leaf).dtype == np.asarray(dict(leaf_paths(plain))[path]).dtype, key
            assert np.array_equal(np.asarray(leaf), np.asarray(dict(leaf_paths(plain))[path])), key
            continue
        spec = flat_specs[key]
        assert isinstance(leaf, DTensor), key
        assert leaf.placements == shd.placements(mesh, spec), (key, leaf.placements)
        local = leaf.to_local()
        assert tuple(local.shape) == shd.local_shape(mesh, spec, tuple(want.shape)), (key, local.shape)
        ref_local = distribute_tensor(want, mesh, leaf.placements).to_local()
        assert local.dtype == want.dtype and torch.equal(local, ref_local), key
        report["sharded_dims"] += int(local.shape != want.shape)
        f = leaf.full_tensor()
        full[key] = f.view(torch.int16) if f.dtype == torch.bfloat16 else f
    if rank == 0:
        torch.save(full, f"{out}/full_{name}.pt")
try:
    restore_checkpoint(ckdirs["port"], shardings={"params": {"no_such_leaf": ()}}, mesh=mesh)
    report["missing_path"] = "restored"
except KeyError as e:
    report["missing_path"] = str(e)
json.dump(report, open(f"{out}/rank{rank}.json", "w"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def saved_state():
    """The reduced model's state as numpy arrays (params, AdamW moments
    moved off their zeros, the step) and one bf16 leaf, from seed 0."""
    cfg = configs.reduced(configs.get_config(ARCH))
    params = init_model(cfg, 0, device="cpu")
    opt = adamw_init(params)
    rng = np.random.default_rng(0)
    opt = {"m": schema.map_tree(opt["m"], lambda t: t + torch.from_numpy(
               rng.standard_normal(tuple(t.shape)).astype(np.float32))),
           "v": schema.map_tree(opt["v"], lambda t: t + 1.0),
           "step": torch.tensor(7, dtype=torch.int32)}
    bf16 = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)).to(torch.bfloat16)
    return {"params": params, "opt": opt,
            "extra": {"w_bf16": bf16, "counter": torch.tensor([3, 1], dtype=torch.int32)}}


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """One checkpoint of ``saved_state`` written by each package."""
    root = tmp_path_factory.mktemp("reshard_ck")
    state = saved_state()
    ckpt.save_checkpoint(root / "port", 7, state)

    def to_jax(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    ref_ckpt.save_checkpoint(root / "ref", 7, jax.tree.map(to_jax, state,
                                                           is_leaf=lambda x: isinstance(x, torch.Tensor)))
    return {"port": str(root / "port"), "ref": str(root / "ref")}


@pytest.fixture(scope="module", params=sorted(MESHES))
def reshard_run(request, ckpt_dirs, tmp_path_factory):
    """(mesh name, output directory) of one two-rank restore."""
    name = request.param
    shape, zero1 = MESHES[name]
    out = tmp_path_factory.mktemp(name)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), PYTHONPATH=str(SRC))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CODE, str(out), json.dumps(ckpt_dirs),
             json.dumps(shape), "1" if zero1 else "0", ARCH, json.dumps(BF16_SPEC)],
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
    return name, out


def _reports(out: Path) -> list:
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]


def test_each_rank_holds_its_own_shard(reshard_run):
    """The ranks' checks passed (DTensors, local shapes, local shards equal to
    distribute_tensor's), at distinct mesh coordinates, and the spec trees
    did split leaves."""
    name, out = reshard_run
    reports = _reports(out)
    assert [r["rank"] for r in reports] == [0, 1]
    assert reports[0]["coordinate"] != reports[1]["coordinate"]
    assert all(r["sharded_dims"] > 0 for r in reports), (name, reports)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_full_tensors_equal_the_reference_restore(reshard_run, ckpt_dirs, writer):
    """Every sharded leaf's ``full_tensor()`` equals ``repro``'s restore of
    the same directory, bit for bit, whichever package wrote it."""
    _, out = reshard_run
    full = torch.load(out / f"full_{writer}.pt")
    want, step = ref_ckpt.restore_checkpoint(ckpt_dirs[writer])
    assert step == 7
    flat = {"/".join(k): v for k, v in schema.leaf_paths(want)}
    assert set(full) == set(flat) - {"extra/counter"}
    for key, got in full.items():
        w = np.asarray(flat[key])
        if w.dtype == np.dtype("V2"):  # the reference's raw bf16 bytes
            w = w.view(np.int16)
        assert got.numpy().dtype == w.dtype and np.array_equal(got.numpy(), w), key


def test_unspecified_leaves_and_a_missing_path(reshard_run):
    """A spec for a path the checkpoint lacks raises KeyError naming it (the
    unspecified leaf's check ran on every rank)."""
    _, out = reshard_run
    for r in _reports(out):
        assert "params/no_such_leaf" in r["missing_path"], r


def test_shardings_without_a_mesh_raise(ckpt_dirs):
    with pytest.raises(ValueError, match="mesh"):
        ckpt.restore_checkpoint(ckpt_dirs["port"], shardings={"params": {}})
