"""Public wrapper: the (B, S, H, N) layout of ``repro``'s RWKV6 code, folded
to the kernel's (B·H, S, N) and back, with ``u`` expanded per head and the
state carried as (B, H, N, N). The kernel runs the recurrence token by
token, so there is no ``chunk`` argument."""
from __future__ import annotations

from .kernel import wkv6_bhsn
from .ref import fold_heads, unfold_heads


def wkv6(r, k, v, logw, u, state=None):
    """r, k, v, logw: (B, S, H, N); u: (H, N); state: (B, H, N, N) or None.
    -> (out (B, S, H, N) fp32, state (B, H, N, N) fp32)."""
    b, _, h, n = r.shape
    ue = u[None].expand(b, h, n).reshape(b * h, n)
    st = None if state is None else state.reshape(b * h, n, n)
    out, st = wkv6_bhsn(*map(fold_heads, (r, k, v, logw)), ue, st)
    return unfold_heads(out, b), st.reshape(b, h, n, n)
