"""k1_roofline (%, kernels): the least ms of the cell's frozen K1 work a
batch (``yardstick.models``) over K1's device ms a batch in the traced
batches: its shared route (``admm_diag_chunk_kernel``) and its stream route
(``admm_stream_kernel``)."""

from mpcbench.yardstick.shares import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "K1", ("admm_diag_chunk_kernel", "admm_stream_kernel"))
