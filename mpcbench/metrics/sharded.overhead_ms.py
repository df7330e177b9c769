"""sharded.overhead_ms (ms, batch / parallel): the median fleet batch
(``solve_sharded``, rank 0, dispatch to the reduced diagnostics on the host)
less the median of the slowest rank's own ``solve_batch_fused`` of its rows
on the same inputs, both timed after the window of the traced run."""

import statistics


def read(ctx):
    s = ctx.get("sharded")
    if not s:
        return None
    slowest = [max(ms) for ms in zip(*s["alone_ms"])]
    return statistics.median(s["fleet_ms"]) - statistics.median(slowest)
