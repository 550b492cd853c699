"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): float32 outside the tensor cores (the port's kernels use
none) and the HBM3's rate."""

PEAK_F32 = 67e12          # FLOP/s
PEAK_BYTES = 3.35e12      # B/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take for this work."""
    return max(flops / PEAK_F32, nbytes / PEAK_BYTES)
