"""Geometry: SE(3), epipolar, the Nistér 5-point solver and robust
essential-matrix estimation, batched over leading dims on the tensors'
device. Port of `featurematching_tpu/geometry/` (the same exports, less
`homography` and `triangulation`, which are not ported yet)."""

from featurematching_tpu_torch.geometry.se3 import (  # noqa: F401
    axis_angle_to_matrix,
    matrix_to_euler_zyx,
    euler_zyx_to_matrix,
    quat_to_matrix,
    matrix_to_quat,
    transform_from_params,
    invert_se3,
    relative_pose_error,
    so3_exp,
    so3_log,
    se3_exp,
    se3_log,
)
from featurematching_tpu_torch.geometry.epipolar import (  # noqa: F401
    cross_product_matrix,
    essential_from_pose,
    symmetric_epipolar_distance,
    sampson_distance,
    normalize_keypoints,
)
from featurematching_tpu_torch.geometry.ransac import (  # noqa: F401
    estimate_essential_ransac,
    decompose_essential,
    recover_pose_from_essential,
)
