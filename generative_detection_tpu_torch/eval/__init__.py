from .detection import evaluate_detections
from .inference import frame_ids_from_batch, pose_inference, recover_boxes
from .metrics import detection_metrics, psnr

__all__ = [
    "evaluate_detections",
    "recover_boxes",
    "frame_ids_from_batch",
    "pose_inference",
    "psnr",
    "detection_metrics",
]
