"""Point clouds, nearest neighbours, ICP, FPFH + RANSAC, dense and brick
TSDF fusion, raycasting, marching cubes (table and tetra), and the CUDA
kernels of the brick paths (``ops.kernels``)."""

from reconplan_tpu_torch.ops.pointcloud import (
    PointCloud,
    backproject_depth,
    voxel_downsample,
    estimate_normals,
    remove_statistical_outliers,
)
from reconplan_tpu_torch.ops.nn import (
    pairwise_sqdist,
    knn,
    nearest_neighbor,
    se3_knn,
)
from reconplan_tpu_torch.ops.icp import (
    ICPResult,
    icp_point_to_point,
    icp_point_to_plane,
    colored_icp,
    register_kabsch,
)
from reconplan_tpu_torch.ops import tsdf, tsdf_brick, marching, features

__all__ = [
    "PointCloud",
    "backproject_depth",
    "voxel_downsample",
    "estimate_normals",
    "remove_statistical_outliers",
    "pairwise_sqdist",
    "knn",
    "nearest_neighbor",
    "se3_knn",
    "ICPResult",
    "icp_point_to_point",
    "icp_point_to_plane",
    "colored_icp",
    "register_kabsch",
    "tsdf",
    "tsdf_brick",
    "marching",
    "features",
]
