"""z remappings between world, patch and learned depth
(``geometry/cameras.py:297-320`` of the JAX package). ``PatchPerspectiveCameras``
comes with the data slice."""


def z_patch_to_world(z_patch, patch_resampling_factor):
    return z_patch * patch_resampling_factor


def z_world_to_patch(z_world, patch_resampling_factor):
    return z_world / patch_resampling_factor


def z_patch_to_learned(z_patch, zmin, zmax):
    return 2.0 * ((z_patch - zmin) / (zmax - zmin)) - 1.0


def z_learned_to_patch(z_learned, zmin, zmax):
    return 0.5 * (z_learned + 1.0) * (zmax - zmin) + zmin


def z_world_to_learned(z_world, zmin, zmax, patch_resampling_factor):
    return z_patch_to_learned(z_world_to_patch(z_world, patch_resampling_factor), zmin, zmax)


def z_learned_to_world(z_learned, zmin, zmax, patch_resampling_factor):
    return z_patch_to_world(z_learned_to_patch(z_learned, zmin, zmax), patch_resampling_factor)
