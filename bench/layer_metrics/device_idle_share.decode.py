"""Device layer: the share of the traced slice in which no kernel, copy
or fill ran on the card (1 - the union of their intervals over the
slice), in %."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
