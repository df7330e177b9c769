"""k3.launches_per_batch (launches, drivers): K3 launches
(``admm_fused.LAUNCHES["K3"]``) over the window's batches; none where K3
did not run."""


def read(ctx):
    n = ctx["launches"].get("K3", 0)
    return n / ctx["batches"] if n and ctx["batches"] else None
