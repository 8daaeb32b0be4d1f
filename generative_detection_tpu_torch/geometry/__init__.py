from .cameras import (
    PatchPerspectiveCameras,
    get_ndc_to_patch_ndc_transform,
    get_patch_ndc_to_ndc_transform,
    z_learned_to_patch,
    z_learned_to_world,
    z_patch_to_learned,
    z_patch_to_world,
    z_world_to_learned,
    z_world_to_patch,
)
from .se3 import se3_exp_map, se3_log_map
from .so3 import euler_angles_to_matrix, hat, matrix_to_euler_angles, so3_exp_map, so3_log_map
from .transforms import Transform, robust_inverse

__all__ = [
    "euler_angles_to_matrix",
    "matrix_to_euler_angles",
    "so3_exp_map",
    "so3_log_map",
    "hat",
    "se3_exp_map",
    "se3_log_map",
    "Transform",
    "robust_inverse",
    "PatchPerspectiveCameras",
    "get_ndc_to_patch_ndc_transform",
    "get_patch_ndc_to_ndc_transform",
    "z_world_to_learned",
    "z_learned_to_world",
    "z_patch_to_learned",
    "z_learned_to_patch",
    "z_world_to_patch",
    "z_patch_to_world",
]
