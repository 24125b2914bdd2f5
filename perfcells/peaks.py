"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W), and the roofline bound of a piece of work."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores

# f32 operations of one voxel-frame of a TSDF update, as counted for the
# port's K1 in csrc/brick_integrate.cu: projection 18, z clamp 1, the two
# pixel coordinates 6; depth / depth_scale, d - z, three tests, the tsdf
# divide and clip 3, weight add, clamp and reciprocal 3, the average 4, the
# empty test and the weight clamp 2.
TSDF_VOXEL_FRAME_OPS = 42


def bound_s(nbytes, nops):
    """(seconds, "bytes" or "operations"): the larger of the bytes over the
    HBM bandwidth and the f32 operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
