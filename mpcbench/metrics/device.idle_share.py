"""device.idle_share (share, device): the share of the traced batches'
host window in which no kernel, copy or set ran on the card."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
