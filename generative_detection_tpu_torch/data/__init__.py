from .datamodule import DataModuleFromConfig
from .synthetic import SyntheticPatchTest, SyntheticPatchTrain, SyntheticPatchValidation

__all__ = [
    "DataModuleFromConfig",
    "SyntheticPatchTrain",
    "SyntheticPatchValidation",
    "SyntheticPatchTest",
]
