"""k3_roofline (%, kernels): the least ms of the cell's frozen K3 work a
batch (``yardstick.models``) over K3's device ms a batch in the traced
batches (``torch.profiler``, CUDA activity)."""

from mpcbench.yardstick.shares import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "K3", ("riccati_admm_chunk_kernel",))
