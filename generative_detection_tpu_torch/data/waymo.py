"""Waymo dataset skeleton (``data/waymo.py`` of the JAX package): the
reference ships the same unimplemented loader; kept as the extension
contract for a Waymo patch pipeline."""

from __future__ import annotations


class WaymoBase:
    def __init__(self, data_root: str, **kwargs):
        self.data_root = data_root
        self.kwargs = kwargs
        self._load()

    def _load(self):
        raise NotImplementedError(
            "Waymo support is a declared extension point (the reference ships "
            "the same unimplemented skeleton, ref waymo.py:25-26)."
        )

    def __len__(self):
        return 0

    def __getitem__(self, idx):
        raise IndexError


class WaymoTrain(WaymoBase):
    split = "train"


class WaymoValidation(WaymoBase):
    split = "validation"
