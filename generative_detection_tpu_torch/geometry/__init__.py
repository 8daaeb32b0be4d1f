from .cameras import (
    z_learned_to_patch,
    z_learned_to_world,
    z_patch_to_learned,
    z_patch_to_world,
    z_world_to_learned,
    z_world_to_patch,
)
from .se3 import se3_exp_map, se3_log_map
from .so3 import euler_angles_to_matrix, hat, matrix_to_euler_angles, so3_exp_map, so3_log_map

__all__ = [
    "euler_angles_to_matrix",
    "matrix_to_euler_angles",
    "so3_exp_map",
    "so3_log_map",
    "hat",
    "se3_exp_map",
    "se3_log_map",
    "z_world_to_learned",
    "z_learned_to_world",
    "z_patch_to_learned",
    "z_learned_to_patch",
    "z_world_to_patch",
    "z_patch_to_world",
]
