"""Core SE3/quaternion math and workspace sampling grids.

Port of ``reconplan_tpu.core``. The maths is plain functions on torch
tensors that broadcast over batch dimensions; the grid *construction*
helpers take and return numpy, since they produce static roadmap data
once per problem (``get_so3_grid`` converts its Euler angles on
``device``, the card by default).
"""

from reconplan_tpu_torch.core.maths import (
    quat_identity,
    quat_normalize,
    quat_mul,
    quat_conj,
    quat_rotate,
    quat_to_matrix,
    matrix_to_quat,
    quat_to_euler,
    euler_to_quat,
    euler_to_matrix,
    rotvec_to_quat,
    quat_to_rotvec,
    quaternion_angle,
    quaternion_close,
    interpolate_quat,
    slerp,
    se3_distance,
    se3_metric,
    wrap_to_pi,
    interpolate_angle,
    circular_mean,
    sample_quat,
    pose_to_matrix,
    matrix_to_pose,
    transform_points,
    look_at_quat,
)
from reconplan_tpu_torch.core.grids import (
    get_staggered_grid,
    get_so3_grid,
    super_fibonacci_so3,
)

__all__ = [
    "quat_identity",
    "quat_normalize",
    "quat_mul",
    "quat_conj",
    "quat_rotate",
    "quat_to_matrix",
    "matrix_to_quat",
    "quat_to_euler",
    "euler_to_quat",
    "euler_to_matrix",
    "rotvec_to_quat",
    "quat_to_rotvec",
    "quaternion_angle",
    "quaternion_close",
    "interpolate_quat",
    "slerp",
    "se3_distance",
    "se3_metric",
    "wrap_to_pi",
    "interpolate_angle",
    "circular_mean",
    "sample_quat",
    "pose_to_matrix",
    "matrix_to_pose",
    "transform_points",
    "look_at_quat",
    "get_staggered_grid",
    "get_so3_grid",
    "super_fibonacci_so3",
]
