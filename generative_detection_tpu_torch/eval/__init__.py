from .inference import pose_inference, recover_boxes

__all__ = ["pose_inference", "recover_boxes"]
