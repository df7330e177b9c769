"""A kernel's share of its roofline: the cell's frozen work against the
kernel's device time in a trace."""

from . import peaks


def kernel_roofline(ctx, kernel, names):
    """100 x the least ms of the cell's frozen work for ``kernel`` a batch
    over the device ms a batch of the kernels whose names contain one of
    ``names`` in the traced batches; none without a trace, frozen work of
    that kernel, or such a kernel in the trace. Refuses a device that is
    not an H100."""
    trace, work = ctx.get("trace"), ctx.get("work")
    if not trace or not work or work["kernel"] != kernel:
        return None
    peaks.require_h100(ctx["device_kind"])
    s = sum(v for k, v in trace["kernels"].items() if any(n in k for n in names))
    if s <= 0:
        return None
    return 100.0 * work["bound_ms"] / (s * 1e3 / ctx["trace_batches"])
