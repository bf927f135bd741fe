"""Flash attention: ``csrc/flash_attention.cu`` for the H100, its wrapper
(``kernel.flash_attention_bhsd``), the (B, S, H, Dh) entry point
(``ops.flash_attention``) and the plain version (``ref.attention_ref``)."""
from .kernel import flash_attention_bhsd, reset_launches
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_attention_bhsd", "reset_launches"]
