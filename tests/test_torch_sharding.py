"""The port's sharding rules, meshes and step trees against ``repro``'s.

``spec_for`` reads only a mesh's axis names and sizes, so both packages run
on shape-only meshes here: ``jax.sharding.AbstractMesh`` for the reference,
``parallel.sharding.AbstractMesh`` for the port, at both production shapes
(16 x 16 and 2 x 16 x 16). Every leaf of every registry architecture gets
the reference's spec, ZeRO-1 axes and leaf count, and ``step_shardings``
the reference's trees for every shape kind. ``hint`` is the identity
without a mesh and for a plain tensor, and redistributes a DTensor under a
one-rank gloo ``DeviceMesh``.
"""
import contextlib
import socket

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as RefAbstractMesh

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_transformer
from repro.parallel import sharding as ref_shd
from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.models.schema import leaf_paths
from repro_torch.parallel import sharding as shd

ARCHS = configs.arch_ids(assigned_only=False)
MESHES = {"pod16x16": False, "pod2x16x16": True}


def _meshes(multi_pod: bool):
    port = mesh_lib.abstract_production_mesh(multi_pod=multi_pod)
    ref = RefAbstractMesh(tuple(port.shape.values()), port.axis_names)
    return port, ref


def _ref_leaves(tree):
    """(path, leaf) of a reference tree in the port's sorted-key order."""
    return list(leaf_paths(tree))


@pytest.mark.parametrize("multi_pod", list(MESHES.values()), ids=list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_gets_the_references_spec_and_zero1_axes(arch, multi_pod):
    pmesh, rmesh = _meshes(multi_pod)
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    prules, rrules = shd.make_rules(pmesh), ref_shd.make_rules(rmesh)
    assert prules == rrules
    axes, raxes = transformer.model_axes(cfg), ref_transformer.model_axes(rcfg)
    ab, rab = transformer.abstract_model(cfg), ref_transformer.abstract_model(rcfg)
    leaves, rleaves = list(leaf_paths(ab)), _ref_leaves(rab)
    assert [p for p, _ in leaves] == [p for p, _ in rleaves]
    pax, rax = dict(leaf_paths(axes)), dict(_ref_leaves(raxes))
    for (path, a), (_, ra) in zip(leaves, rleaves):
        assert tuple(a.shape) == tuple(ra.shape) and a.device.type == "meta"
        assert str(a.dtype).split(".")[-1] == str(ra.dtype), path
        logical = pax[path]
        assert logical == rax[path], path
        spec = shd.spec_for(pmesh, prules, logical, tuple(a.shape))
        assert spec == tuple(ref_shd.spec_for(rmesh, rrules, logical, ra.shape)), path
        z = shd.zero1_axes(logical, tuple(a.shape), pmesh, prules)
        assert z == ref_shd.zero1_axes(logical, ra.shape, rmesh, rrules), path
        assert shd.spec_for(pmesh, prules, z, tuple(a.shape)) == tuple(
            ref_shd.spec_for(rmesh, rrules, z, ra.shape)), path
    tree = shd.tree_shardings(pmesh, prules, axes, ab)
    rtree = ref_shd.tree_shardings(rmesh, rrules, raxes, rab)
    assert len(list(leaf_paths(tree))) == len(
        jax.tree.leaves(rtree, is_leaf=lambda x: hasattr(x, "spec")))


def test_spec_rules_by_hand():
    """The reference's own cases: divisible, the divisibility fallback, no
    mesh axis used twice, ZeRO-1 on the first replicated dim."""
    m = shd.AbstractMesh((1, 4), ("data", "model"))
    rules = shd.make_rules(m)
    assert rules["batch"] == "data"  # "pod" dropped on the single-pod mesh
    assert shd.spec_for(m, rules, ("embed", "mlp"), (64, 128)) == (None, "model")
    assert shd.spec_for(m, rules, ("embed", "heads"), (64, 6)) == ()  # 6 % 4
    spec = shd.spec_for(m, shd.make_rules(m, {"embed": "model"}), ("embed", "mlp"), (64, 128))
    assert spec == ("model",)
    assert shd.zero1_axes(("embed", "mlp"), (64, 128), m, rules)[0] == "batch"
    ax = ("experts", "embed", "expert_ff")
    assert shd.zero1_axes(ax, (8, 64, 128), m, rules) == ax
    assert shd.local_shape(m, (None, "model"), (64, 128)) == (64, 32)


KINDS = [("internlm2-1.8b", "train_4k"), ("mixtral-8x22b", "train_4k"),
         ("whisper-large-v3", "prefill_32k"), ("internvl2-2b", "train_4k"),
         ("rwkv6-3b", "decode_32k"), ("hymba-1.5b", "decode_32k"),
         ("starcoder2-15b", "decode_32k"), ("granite-3-8b", "prefill_32k")]


def _ref_spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _ref_spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_ref_spec_tree(v) for v in tree)
    return tuple(tree.spec)


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("multi_pod", list(MESHES.values()), ids=list(MESHES))
@pytest.mark.parametrize("arch,shape", KINDS)
def test_step_shardings_match_the_references(arch, shape, multi_pod, zero1):
    pmesh, rmesh = _meshes(multi_pod)
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    pin, pout, prules = steps.step_shardings(cfg, configs.get_shape(shape), pmesh, zero1=zero1)
    rin, rout, rrules = ref_steps.step_shardings(rcfg, ref_configs.get_shape(shape), rmesh,
                                                 zero1=zero1)
    assert prules == rrules
    assert pin == _ref_spec_tree(rin)
    assert pout == _ref_spec_tree(rout)
    assert steps.cache_axes(cfg, pmesh) == ref_steps.cache_axes(rcfg, rmesh)
    assert steps.batch_axes(cfg, True) == ref_steps.batch_axes(rcfg, True)


def test_abstract_cache_and_optimizer_state():
    cfg = configs.reduced(configs.get_config("hymba-1.5b"))
    cache = transformer.abstract_cache(cfg, 2, 16)
    want = transformer.cache_spec(cfg, 2, 16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == want
    assert all(v.device.type == "meta" for v in cache.values())
    params = transformer.init_model(cfg, 0, device="cpu")
    opt = steps.make_optimizer_state(cfg, params)
    assert int(opt["step"]) == 0 and sorted(opt) == ["m", "step", "v"]


def test_production_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        mesh_lib.make_production_mesh()
    assert mesh_lib.abstract_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert mesh_lib.dp_world() == (0, 1, 0)
    assert mesh_lib.init_data_parallel(torch.device("cpu")) is None
    assert not dist.is_initialized()


def test_hint_is_the_identity_without_a_mesh():
    x = torch.ones(4, 4)
    assert shd.hint(x, ("batch", None)) is x
    with shd.use_mesh(shd.AbstractMesh((16, 16), ("data", "model"))):
        assert shd.hint(x, ("batch", "mlp")) is x  # a plain tensor
        assert shd.current_rules()["batch"] == "data"
    assert shd.current_mesh() is None


@contextlib.contextmanager
def one_rank_gloo():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_hint_applies_under_a_one_rank_gloo_mesh():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with one_rank_gloo():
        mesh = mesh_lib.make_local_mesh()
        assert shd.mesh_axes(mesh) == {"data": 1, "model": 1}
        x = torch.arange(4 * 128, dtype=torch.float32).reshape(4, 128)
        xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        with shd.use_mesh(mesh):
            y = shd.hint(xd, ("batch", "mlp"))
            assert shd.hint(x, ("batch", "mlp")) is x
            assert shd.hint(xd, ("moe_group", "mlp")) is xd  # no such rule
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert torch.equal(y.full_tensor(), x)
        assert shd.placements(mesh, ("data",)) == (Shard(0), Replicate())
