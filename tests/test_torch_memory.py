"""The dry run's temporary-memory count (``repro_torch.analysis.memory``), on
the CPU, at reduced configs.

The count over ``meta`` tensors equals the same count over real CPU
tensors to the byte (both through the kernels' plain versions), for every
remat policy and for prefill and decode; the policies order as they must
(nothing >= dots >= full); a rank's batch-sharded part doubles exactly when
the data axis halves; the model axis narrows the widths ``spec_for`` shards;
and under ``device.kernel_footprint`` attention and WKV6 count what their
kernels allocate, which is less than the plain versions' scores. The
reference has no counterpart to hold these against: its figure comes from
XLA's buffer assignment (``memory_analysis()``), which the port has no
compiler for.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.analysis import memory
from repro_torch.configs import ShapeConfig
from repro_torch.device import kernel_footprint
from repro_torch.parallel.sharding import AbstractMesh, make_rules

ARCHS = ["internlm2-1.8b", "rwkv6-3b", "mixtral-8x22b", "whisper-large-v3"]
POLICIES = ["nothing", "dots", "full"]
SEQ, BATCH = 32, 2


def _cfg(arch, policy=None):
    cfg = configs.reduced(configs.get_config(arch))
    return cfg if policy is None else dataclasses.replace(cfg, remat_policy=policy)


def _shape(cfg, kind, batch=BATCH):
    extra = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    return ShapeConfig("t", kind, SEQ + extra, batch)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_count_on_meta_equals_real_tensors(arch, policy):
    cfg = _cfg(arch, policy)
    meta = memory.count_temp(cfg, _shape(cfg, "train"))
    real = memory.count_temp(cfg, _shape(cfg, "train"), device="cpu")
    # the saved / kept split reads storage keys, which a freed storage may
    # pass on in either allocator's own order; the total is exact
    assert meta["total"] == real["total"] and meta["head"] == real["head"]
    assert meta["total"] > meta["head"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS + ["internvl2-2b"])
def test_inference_count_on_meta_equals_real_tensors(arch, kind):
    cfg = _cfg(arch)
    meta = memory.count_temp(cfg, _shape(cfg, kind))
    real = memory.count_temp(cfg, _shape(cfg, kind), device="cpu")
    assert meta == real and meta["total"] == meta["peak"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_order(arch):
    got = {p: memory.count_temp(_cfg(arch, p), _shape(_cfg(arch), "train"))["total"]
           for p in POLICIES}
    assert got["nothing"] >= got["dots"] >= got["full"] > 0
    assert got["nothing"] > got["full"]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-3b"])
def test_halving_the_data_axis_doubles_the_batch_part(arch):
    """A rank's count at 1, 2 and 4 rows (data axis 4, 2, 1 over a batch of
    4): the batch-independent part (the weights' compute-dtype casts the
    forward keeps) cancels, and each halving doubles the rest exactly."""
    cfg = _cfg(arch)
    shape = ShapeConfig("t", "train", SEQ, 4)
    t = {}
    for data in (4, 2, 1):
        mesh = AbstractMesh((data, 1), ("data", "model"))
        assert memory.local_batch(mesh, make_rules(mesh), 4) == 4 // data
        t[data] = memory.rank_temp(cfg, shape, mesh, make_rules(mesh))["total"]
    assert t[1] - t[2] == 2 * (t[2] - t[4]) > 0


def test_microbatches_split_the_local_batch():
    cfg = _cfg("internlm2-1.8b")
    mesh = AbstractMesh((2, 1), ("data", "model"))
    shape = ShapeConfig("t", "train", SEQ, 8)
    whole = memory.rank_temp(cfg, shape, mesh, make_rules(mesh))
    micro = memory.rank_temp(cfg, shape, mesh, make_rules(mesh), microbatches=2)
    with kernel_footprint():
        one = memory.count_temp(cfg, ShapeConfig("t", "train", SEQ, 2))
    assert micro == one and micro["total"] < whole["total"]


def test_the_model_axis_narrows_the_sharded_widths():
    """(data 1, model 2) on reduced internlm2 (vocab 256, d_ff 128, 4 heads,
    2 kv heads): each sharded width halves; the rank's count is smaller."""
    cfg = _cfg("internlm2-1.8b")
    mesh = AbstractMesh((1, 2), ("data", "model"))
    local = memory.rank_config(cfg, mesh, make_rules(mesh))
    assert (local.vocab_size, local.d_ff, local.n_heads, local.n_kv_heads, local.head_dim) == (
        cfg.vocab_size // 2, cfg.d_ff // 2, cfg.n_heads // 2, cfg.n_kv_heads // 2, cfg.head_dim)
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    whole = AbstractMesh((1, 1), ("data", "model"))
    assert (memory.rank_temp(cfg, shape, mesh, make_rules(mesh))["total"]
            < memory.rank_temp(cfg, shape, whole, make_rules(whole))["total"])
    # kv heads that do not divide keep attention whole
    mesh4 = AbstractMesh((1, 4), ("data", "model"))
    local4 = memory.rank_config(cfg, mesh4, make_rules(mesh4))
    assert (local4.n_heads, local4.n_kv_heads) == (cfg.n_heads, cfg.n_kv_heads)
    assert local4.d_ff == cfg.d_ff // 4


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-3b"])
def test_kernel_footprint_drops_the_plain_intermediates(arch):
    """Under the kernels' footprint the prefill's peak and the saved tensors
    of an unremat'ed step leave out the plain versions' intermediates
    (attention's scores, the chunked WKV6 products); remat'ed steps keep
    none of them either way."""
    def both(cfg, kind):
        plain = memory.count_temp(cfg, _shape(cfg, kind))["total"]
        with kernel_footprint():
            return plain, memory.count_temp(cfg, _shape(cfg, kind))["total"]

    cfg = _cfg(arch, "nothing")
    for kind in ("prefill", "train"):
        plain, kern = both(cfg, kind)
        assert 0 < kern < plain, kind
    plain, kern = both(_cfg(arch, "full"), "train")
    assert plain == kern


def test_kernel_footprint_is_meta_only():
    """On the CPU the wrappers compute under the footprint context as
    without it (the plain versions); only meta tensors skip computing."""
    from repro_torch.kernels.flash_attention import kernel as FK

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 8, 16), generator=g) for _ in range(3))
    want = FK.flash_attention_bhsd(q, k, v)
    with kernel_footprint():
        got = FK.flash_attention_bhsd(q, k, v)
        m = FK.flash_attention_bhsd(*(x.to("meta") for x in (q, k, v)))
    assert torch.equal(got, want) and m.shape == want.shape and m.device.type == "meta"
