from .contperceptual import LPIPSWithDiscriminator, PoseLoss, adopt_weight, build_prior_tables

__all__ = ["LPIPSWithDiscriminator", "PoseLoss", "adopt_weight", "build_prior_tables"]
