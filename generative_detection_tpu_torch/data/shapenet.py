"""ShapeNet dataset contract (``data/shapenet.py`` of the JAX package).

The reference's ShapeNet path (``src/data/datasets/shapenet.py``) imports a
module its repository does not have (``src.util.pose_transforms``), so it
cannot run there either. The class surface stays as the extension contract;
its item keys are the nuScenes patch contract, so a working loader drops into
the same training stack.
"""

from __future__ import annotations


class ShapeNetBase:
    REQUIRED_ITEM_KEYS = (
        "patch",
        "class_id",
        "original_class_id",
        "class_name",
        "pose_6d",
        "bbox_sizes",
        "yaw",
        "fill_factor",
        "mask_2d_bbox",
    )

    def __init__(self, config=None, **kwargs):
        raise NotImplementedError(
            "The ShapeNet path is non-functional in the reference (missing "
            "src/util/pose_transforms.py, ref shapenet.py:16) and is kept "
            "here as a declared extension contract only."
        )


class ShapeNetTrain(ShapeNetBase):
    split = "train"


class ShapeNetValidation(ShapeNetBase):
    split = "validation"


class ShapeNetTest(ShapeNetBase):
    split = "test"
