from .attention import single_head_attention
from .norm import group_norm
from . import library  # noqa: F401  (registers the gdt operators)

__all__ = ["group_norm", "single_head_attention"]
