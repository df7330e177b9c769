"""solve_mfu (%, batch / parallel): the whole batch solve's share of the
H100's peak, read on the host clock: the ms of the cell's frozen work's
operations at the published peaks over the window's median batch ms
(dispatch to results on the host)."""

import statistics

from mpcbench.yardstick import peaks


def read(ctx):
    work = ctx.get("work")
    if not work or not ctx["batch_ms"]:
        return None
    peaks.require_h100(ctx["device_kind"])
    return 100.0 * work["ops_ms"] / statistics.median(ctx["batch_ms"])
