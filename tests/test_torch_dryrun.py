"""The port's dry run (``python -m repro_torch.launch.dryrun``) against
``repro``'s.

Three cells — a train (internlm2-1.8b ``train_4k``), a decode (qwen1.5-0.5b
``decode_32k``) and a skip (qwen1.5-0.5b ``long_500k``) — carry the
reference's artifact keys and statuses; the reference's artifacts come from
its own CLI in a subprocess (it fakes 512 host devices, which must not
happen in this process). One rank's argument and output bytes equal the
sum of the local shards under the reference's specs
(``repro.launch.steps.step_shardings`` on a ``jax.sharding.AbstractMesh``),
and the counted step FLOPs are within 25 % of the analytic ``flops_step``.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import frontends as ref_frontends
from repro.models import transformer as ref_transformer
from repro_torch.analysis import roofline
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("internlm2-1.8b", "train_4k", "ok"), ("qwen1.5-0.5b", "decode_32k", "ok"),
         ("qwen1.5-0.5b", "long_500k", "skipped")]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(port, reference) artifacts of every cell on the single-pod mesh: the
    port's from its CLI in this process, the reference's decode and skip
    from its CLI in a subprocess (its train cell compiles for minutes; the
    decode cell's keys are every ok cell's)."""
    out = tmp_path_factory.mktemp("dryrun")
    for arch, shape, _ in CELLS:
        dryrun.main(["--arch", arch, "--shape", shape, "--out-dir", str(out / "port")])
        if shape != "train_4k":
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
            subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
                            "--shape", shape, "--out-dir", str(out / "ref")],
                           env=env, check=True, capture_output=True, timeout=120)

    def load(side, arch, shape):
        p = out / side / f"{arch}_{shape}_pod16x16.json"
        return json.loads(p.read_text()) if p.exists() else None

    return {(a, s): (load("port", a, s), load("ref", a, s)) for a, s, _ in CELLS}


@pytest.mark.parametrize("arch,shape,status", CELLS)
def test_cells_have_the_references_keys_and_status(artifacts, arch, shape, status):
    port, ref = artifacts[arch, shape]
    ref = ref or artifacts["qwen1.5-0.5b", "decode_32k"][1]  # every ok cell's keys
    assert port["status"] == status
    if status == "skipped":
        assert port == ref  # the reason and the config counts too
        return
    assert set(ref) <= set(port)
    assert set(port) - set(ref) == {"roofline"}
    for key in ("arch", "shape", "mesh", "kind", "n_params", "n_params_active",
                "n_matmul_params_active", "tokens_per_step", "n_chips", "zero1"):
        if ref["arch"] == arch:
            assert port[key] == ref[key], key
    assert sorted(port["variant"]) == sorted(ref["variant"])
    assert sorted(port["collectives"]) == sorted(["source", *ref["collectives"]])
    assert port["collectives"]["source"] == "analytic"
    mem = port["memory_analysis"]
    assert {"argument_size_in_bytes", "output_size_in_bytes"} <= set(mem)
    assert isinstance(mem["temp_size_in_bytes"], int) and mem["temp_size_in_bytes"] > 0
    assert isinstance(mem["temp_source"], str) and "counted" in mem["temp_source"]
    assert port["roofline"] == roofline.roofline_terms(
        dryrun.get_config(arch), dryrun.get_shape(shape), roofline.MESHES["pod16x16"],
        {"remat": port["variant"]["remat"], "param_dtype": port["variant"]["param_dtype"],
         "zero1": False})


def _local_bytes(mesh, shardings, values) -> int:
    """One rank's bytes of a reference tree under its NamedShardings."""
    total = 0
    for sh, v in zip(jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec")),
                     jax.tree.leaves(values)):
        shape = list(v.shape)
        for d, entry in enumerate(sh.spec):
            axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
            shape[d] //= math.prod(mesh.shape[a] for a in axes)
        total += math.prod(shape) * np.dtype(v.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape", [("internlm2-1.8b", "train_4k"),
                                        ("qwen1.5-0.5b", "decode_32k")])
def test_per_rank_bytes_are_the_references_local_shards(artifacts, arch, shape):
    port = artifacts[arch, shape][0]
    cfg, shp = ref_configs.get_config(arch), ref_configs.get_shape(shape)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    in_sh, out_sh, _ = ref_steps.step_shardings(cfg, shp, mesh)
    params = ref_transformer.abstract_model(cfg)
    specs = ref_frontends.input_specs(cfg, shp)
    f32 = jax.ShapeDtypeStruct((), np.float32)
    if shp.kind == "train":
        mom = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, np.float32), params)
        opt = {"m": mom, "v": mom, "step": jax.ShapeDtypeStruct((), np.int32)}
        args = (params, opt, specs["batch"])
        outs = (params, opt, {k: f32 for k in out_sh[2]})
    else:
        logits = jax.ShapeDtypeStruct((shp.global_batch, 1, cfg.vocab_size), np.dtype(cfg.dtype))
        args = (params, specs["cache"], specs["tokens"], specs["pos"])
        outs = (logits, specs["cache"])
    mem = port["memory_analysis"]
    assert mem["argument_size_in_bytes"] == sum(
        _local_bytes(mesh, s, a) for s, a in zip(in_sh, args))
    assert mem["output_size_in_bytes"] == sum(
        _local_bytes(mesh, s, o) for s, o in zip(out_sh, outs))


def test_counted_step_flops_near_the_analytic_model(artifacts):
    port = artifacts["internlm2-1.8b", "train_4k"][0]
    want = port["roofline"]["flops_total"]
    assert port["cost_analysis"]["flops"] == pytest.approx(want, rel=0.25)


@pytest.mark.parametrize("flag", ["--unroll", "--moe-ep-hints"])
def test_flags_of_variants_the_port_does_not_run_refuse(tmp_path, flag, capsys):
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", flag,
                     "--out-dir", str(tmp_path)])
    assert exc.value.code == 2
    assert flag in capsys.readouterr().err
    assert not any(tmp_path.iterdir())  # no artifact claims the variant
