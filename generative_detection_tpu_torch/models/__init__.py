from .autoencoder import (
    Autoencoder,
    AutoencoderKLNet,
    PoseAutoencoder,
    PoseAutoencoderNet,
    rescale_minmax,
)
from .blocks import Decoder, Encoder
from .pose_modules import PoseDecoderSpatialVAE, PoseEncoderSpatialVAE

__all__ = [
    "Autoencoder",
    "AutoencoderKLNet",
    "LPIPSWithDiscriminator",
    "PoseAutoencoder",
    "PoseAutoencoderNet",
    "rescale_minmax",
    "Encoder",
    "Decoder",
    "PoseDecoderSpatialVAE",
    "PoseEncoderSpatialVAE",
]


def __getattr__(name):
    # the losses import this package's modules, so the loss comes in lazily
    if name == "LPIPSWithDiscriminator":
        from ..losses.contperceptual import LPIPSWithDiscriminator

        return LPIPSWithDiscriminator
    raise AttributeError(name)
