"""Cross-cutting utilities: math, logging, helpers, errors."""

from leibnizgym_tpu_torch.utils.errors import InvalidTaskNameError
from leibnizgym_tpu_torch.utils.helpers import get_resources_dir, merged_dict, update_dict
from leibnizgym_tpu_torch.utils.message import (
    print_debug,
    print_dict,
    print_error,
    print_info,
    print_notify,
    print_warn,
)

__all__ = [
    "InvalidTaskNameError",
    "get_resources_dir",
    "merged_dict",
    "update_dict",
    "print_debug",
    "print_dict",
    "print_error",
    "print_info",
    "print_notify",
    "print_warn",
]
