"""The port's analytic roofline (H100 rates) against ``repro``'s (TPU v5e
rates), and its FLOP model against the port's own counted step.

Every rate-free quantity (FLOPs, per-device HBM and collective bytes, the
useful-FLOP fraction, the lease plane's byte model) is float-equal to the
reference's for every arch x shape x mesh; each time term is the
reference's scaled by the ratio of the two rates. The reference's own
checks are ported with ``analysis.costs`` (``FlopCounterMode``) in place of
XLA's ``cost_analysis()``: the analytic forward FLOPs within 25 % of the
counted forward on reduced qwen1.5-0.5b and internlm2-1.8b, a train step
between 2 and 4 forwards, ``model_flops`` = 6·N·D.
"""
import dataclasses

import pytest
import torch

from repro.analysis import roofline as R
from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.analysis import roofline as T
from repro_torch.analysis.costs import cost_analysis_dict
from repro_torch.lease_array.kernel import delayed_launch_plan, sync_launch_plan
from repro_torch.models import init_model, loss_fn, transformer

VARIANTS = [None, {"zero1": True, "param_dtype": "bfloat16", "remat": "full",
                   "swa_block_skip": True, "logits_last": True},
            {"remat": "nothing"}]
RATE_FREE = ("flops_total", "model_flops", "useful_flops_frac", "hbm_bytes_per_dev",
             "coll_bytes_per_dev")
SCALE = {"compute_s": R.PEAK_FLOPS / T.PEAK_FLOPS, "memory_s": R.HBM_BW / T.HBM_BW,
         "collective_s": R.LINK_BW / T.LINK_BW}


def test_the_rates_are_the_h100s():
    assert (T.PEAK_FLOPS, T.HBM_BW, T.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert T.INT32_OPS_PER_S == 64 * 132 * 1.98e9
    assert T.MESHES.keys() == R.MESHES.keys()
    for k, m in T.MESHES.items():
        assert (m.pod, m.data, m.model, m.chips, m.dp) == (
            R.MESHES[k].pod, R.MESHES[k].data, R.MESHES[k].model, R.MESHES[k].chips,
            R.MESHES[k].dp)


@pytest.mark.parametrize("mesh", list(R.MESHES))
@pytest.mark.parametrize("arch", configs.arch_ids())
def test_rate_free_quantities_equal_the_references(arch, mesh):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    pm, rm = T.MESHES[mesh], R.MESHES[mesh]
    for name in configs.SHAPES:
        shape, rshape = configs.get_shape(name), ref_configs.get_shape(name)
        for v in VARIANTS:
            for fn in ("flops_fwd", "flops_step"):
                assert getattr(T, fn)(cfg, shape, v) == getattr(R, fn)(rcfg, rshape, v)
            assert T.model_flops(cfg, shape) == R.model_flops(rcfg, rshape)
            for fn in ("hbm_bytes_per_device", "collective_bytes_per_device"):
                assert getattr(T, fn)(cfg, shape, pm, v) == getattr(R, fn)(rcfg, rshape, rm, v)
            by_op = T.collective_bytes_by_op(cfg, shape, pm, v)
            assert sum(by_op.values()) == pytest.approx(
                R.collective_bytes_per_device(rcfg, rshape, rm, v), rel=1e-12)
            got, want = T.roofline_terms(cfg, shape, pm, v), R.roofline_terms(rcfg, rshape, rm, v)
            assert sorted(got) == sorted(want)
            for k in RATE_FREE:
                assert got[k] == want[k], (name, v, k)
            for k, scale in SCALE.items():
                assert got[k] == pytest.approx(want[k] * scale, rel=1e-12), (name, v, k)
            assert got["step_time_bound_s"] == max(got[k] for k in SCALE)
            assert got["dominant"] == max(SCALE, key=got.get).replace("_s", "")


@pytest.mark.parametrize("delayed", [True, False])
@pytest.mark.parametrize("n_cells,a,p", [(1 << 20, 5, 8), (1 << 14, 3, 4), (1000, 5, 8)])
def test_lease_plane_roofline_keeps_the_byte_model(n_cells, a, p, delayed):
    got = T.lease_plane_roofline(n_cells, a, p, delayed=delayed)
    want = R.lease_plane_roofline(n_cells, a, p, delayed=delayed)
    for k in ("resident_hbm_bytes_per_tick", "dispatch_hbm_bytes_per_tick", "hbm_traffic_ratio"):
        assert got[k] == want[k], k
    for k in ("memory_s_per_tick_resident", "memory_s_per_tick_dispatch"):
        assert got[k] == pytest.approx(want[k] * R.HBM_BW / T.HBM_BW, rel=1e-12)
    assert got["compute_s_per_tick"] == pytest.approx(
        want["compute_s_per_tick"] * (R.PEAK_FLOPS / 2) / T.INT32_OPS_PER_S, rel=1e-12)
    plan = (delayed_launch_plan if delayed else sync_launch_plan)(a, n_cells, p, 16, window=16)
    assert got["smem_bytes_at_window"] == plan.smem_bytes > 0
    assert "vmem_bytes_at_window" not in got
    assert got["bound"] == ("compute" if got["compute_s_per_tick"]
                            > got["memory_s_per_tick_resident"] else "memory")


def _small(arch, **kw):
    return dataclasses.replace(configs.reduced(configs.get_config(arch)), remat_policy="nothing",
                               n_layers=4, vocab_size=512, **kw)


def _counted(cfg, shape, train: bool, device="cpu") -> float:
    params = init_model(cfg, 0, device=device) if device == "cpu" else \
        transformer.abstract_model(cfg)
    b, s = shape.global_batch, shape.seq_len
    tokens = torch.zeros((b, s), dtype=torch.int32, device=device)
    if not train:
        return cost_analysis_dict(transformer.forward, cfg, params, {"tokens": tokens})["flops"]

    def grad(p):
        for leaf in torch.utils._pytree.tree_leaves(p):
            leaf.requires_grad_(True)
        loss_fn(cfg, p, {"tokens": tokens, "labels": tokens}, remat=False)[0].backward()

    return cost_analysis_dict(grad, params)["flops"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internlm2-1.8b"])
def test_analytic_fwd_flops_vs_counted_forward(arch, device):
    cfg = _small(arch)
    shape = configs.ShapeConfig("t", "prefill", 64, 4)
    got = _counted(cfg, shape, train=False, device=device)
    want = T.flops_fwd(cfg, shape)
    assert got == pytest.approx(want, rel=0.25), f"analytic {want:.3e} vs counted {got:.3e}"


def test_train_flops_roughly_3x_forward():
    cfg = _small("qwen1.5-0.5b")
    fwd = _counted(cfg, configs.ShapeConfig("t", "prefill", 64, 4), train=False)
    train = _counted(cfg, configs.ShapeConfig("t", "train", 64, 4), train=True)
    assert 2.0 < train / fwd < 4.0


def test_model_flops_is_6nd():
    cfg = configs.get_config("granite-3-8b")
    shape = configs.ShapeConfig("t", "train", 4096, 256)
    assert T.model_flops(cfg, shape) == pytest.approx(
        6 * cfg.matmul_params() * 4096 * 256, rel=1e-9)


@pytest.mark.parametrize("mesh", list(T.MESHES))
def test_roofline_terms_positive_and_classified(mesh):
    for arch, shape_name in [("granite-3-8b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k")]:
        t = T.roofline_terms(configs.get_config(arch), configs.get_shape(shape_name),
                             T.MESHES[mesh])
        assert t["compute_s"] > 0 and t["memory_s"] > 0 and t["collective_s"] > 0
        assert t["dominant"] in ("compute", "memory", "collective")
        assert 0 < t["useful_flops_frac"] <= 1.2
