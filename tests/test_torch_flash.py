"""The port's flash attention against ``repro``'s, on the CPU.

On the CPU ``flash_attention`` runs the plain version (``attention_ref``);
it is held against ``repro``'s Pallas kernel in interpret mode on the seven
cases of ``tests/test_kernels_flash.py``, with that file's tolerances (5e-5
fp32, 2.5e-2 bf16). Ragged lengths, which the Pallas kernel refuses, are
held against ``repro``'s plain ``attention_ref``. The kernel itself is held
against the plain version on the card in ``test_torch_flash_kernel.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from test_torch_flash_kernel import CASES, RAGGED, TORCH_DT, case_id, fold, inputs, tol

JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _port(arrays, dt, **kw):
    q, k, v = (torch.from_numpy(a).to(TORCH_DT[dt]) for a in arrays)
    return flash_attention(q, k, v, **kw).float().numpy()


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_matches_reference_kernel(case):
    *_, causal, window, dt = case
    arrays = inputs(case)
    got = _port(arrays, dt, causal=causal, window=window)
    q, k, v = (jnp.asarray(a).astype(JNP_DT[dt]) for a in arrays)
    want = np.asarray(ref_flash(q, k, v, causal=causal, window=window,
                                block_q=64, block_k=64).astype(jnp.float32))
    assert np.abs(got - want).max() < tol(dt)


@pytest.mark.parametrize("case", RAGGED, ids=case_id)
def test_plain_matches_reference_on_ragged_lengths(case):
    b, sq, sk, hq, hkv, dh, causal, window, dt = case
    arrays = inputs(case, seed=1)
    got = _port(arrays, dt, causal=causal, window=window)
    q, k, v = (jnp.asarray(fold(a)).astype(JNP_DT[dt]) for a in arrays)
    want = np.asarray(ref_attention(q, k, v, causal=causal, window=window)
                      .astype(jnp.float32))
    want = want.reshape(b, hq, sq, dh).transpose(0, 2, 1, 3)
    assert np.abs(got - want).max() < tol(dt)
