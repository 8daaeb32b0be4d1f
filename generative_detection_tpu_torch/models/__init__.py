from .autoencoder import PoseAutoencoder, PoseAutoencoderNet, rescale_minmax
from .blocks import Decoder, Encoder
from .pose_modules import PoseDecoderSpatialVAE, PoseEncoderSpatialVAE

__all__ = [
    "PoseAutoencoder",
    "PoseAutoencoderNet",
    "rescale_minmax",
    "Encoder",
    "Decoder",
    "PoseDecoderSpatialVAE",
    "PoseEncoderSpatialVAE",
]
