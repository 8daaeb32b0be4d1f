from .instantiate import TARGET_ALIASES, get_obj_from_str, instantiate_from_config
from .merge import apply_dotlist, deep_merge, load_yaml, merge_configs, to_plain

__all__ = [
    "instantiate_from_config",
    "get_obj_from_str",
    "TARGET_ALIASES",
    "load_yaml",
    "merge_configs",
    "deep_merge",
    "apply_dotlist",
    "to_plain",
]
