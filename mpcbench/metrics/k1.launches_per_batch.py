"""k1.launches_per_batch (launches, drivers): K1 launches
(``admm_fused.LAUNCHES["K1"]``, highest precision) over the window's
batches; none where K1 did not run."""


def read(ctx):
    n = ctx["launches"].get("K1", 0)
    return n / ctx["batches"] if n and ctx["batches"] else None
