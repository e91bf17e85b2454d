"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet,
dense, at the full 700 W power limit), against which every share of a
roofline or of a peak is stated.

``FLOPS`` is the dense TF32 tensor-core rate: the port trains in fp32,
and a path that keeps fp32 accuracy on the tensor cores (as the flash
kernels' three TF32 passes do) runs under it, so it bounds every
fp32-accurate path, also where the fp32 GEMMs run today, outside the
tensor cores at 66.9 TFLOP/s.
"""
FLOPS = 494.7e12            # flop/s, TF32 tensor cores, dense
HBM_BYTES = 3.35e12         # bytes/s


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take for ``flops`` operations that
    move ``nbytes`` bytes: the larger of the two bounds."""
    return max(flops / FLOPS, nbytes / HBM_BYTES)
