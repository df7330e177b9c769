"""Published peaks of one NVIDIA H100 SXM at its 700 W power limit (NVIDIA's
data sheet, dense rates without sparsity)."""

HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 67e12  # fp64 on the tensor cores
FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12


def require_h100(kind: str) -> None:
    """Raise ValueError unless ``kind`` (``torch.cuda.get_device_name``)
    names an H100: these peaks are no other device's."""
    if "H100" not in str(kind):
        raise ValueError(f"the yardstick holds the H100's peaks only, not {kind!r}'s")
