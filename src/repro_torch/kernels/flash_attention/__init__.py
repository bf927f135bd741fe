"""Flash attention: the forward kernels of ``csrc/`` and the backward of
``csrc/flash_attention_bwd.cu`` for the H100, their wrapper
(``kernel.flash_attention_bhsd``, differentiable through
``kernel.FlashAttention``), the (B, S, H, Dh) entry point
(``ops.flash_attention``) and the plain versions (``ref``)."""
from .kernel import FlashAttention, flash_attention_bhsd, reset_launches
from .ops import flash_attention
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

__all__ = ["FlashAttention", "attention_bwd_ref", "attention_lse_ref", "attention_ref",
           "flash_attention", "flash_attention_bhsd", "reset_launches"]
