from .attention import single_head_attention
from .norm import group_norm

__all__ = ["group_norm", "single_head_attention"]
