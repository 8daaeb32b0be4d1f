from .contperceptual import PoseLoss, adopt_weight, build_prior_tables

__all__ = ["PoseLoss", "adopt_weight", "build_prior_tables"]
