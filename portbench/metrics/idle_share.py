"""Share of the traced window (a training step, or a pass of prefill
requests) with no kernel on the card. Reads ``idle_share.<kind>``."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
