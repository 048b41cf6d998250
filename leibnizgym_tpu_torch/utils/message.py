"""Colored, timestamped, caller-tagged console logging (the port's own copy
of the JAX package's ``leibnizgym_tpu/utils/message.py``)."""

from __future__ import annotations

import datetime
import inspect
import os

try:
    from termcolor import colored
except ImportError:  # pragma: no cover - termcolor is optional
    def colored(text, *_args, **_kwargs):
        return text


def _caller_module() -> str:
    frame = inspect.stack()[3] if len(inspect.stack()) > 3 else inspect.stack()[-1]
    return os.path.splitext(os.path.basename(frame.filename))[0]


def _log(level: str, color: str, *args):
    stamp = datetime.datetime.now().strftime("%H:%M:%S")
    tag = f"[{level}] [{stamp}] [{_caller_module()}]"
    print(colored(tag, color), *args)


def print_info(*args):
    _log("INFO", "green", *args)


def print_debug(*args):
    _log("DEBUG", "cyan", *args)


def print_notify(*args):
    _log("NOTIFY", "blue", *args)


def print_warn(*args):
    _log("WARN", "yellow", *args)


def print_error(*args):
    _log("ERROR", "red", *args)


def _dict_lines(val, indent: int):
    """Yield 'key: value' lines for a nested mapping, children indented 4 deeper."""
    for key, child in val.items():
        if isinstance(child, dict):
            yield f"{' ' * indent}{key}: "
            yield from _dict_lines(child, indent + 4)
        else:
            yield f"{' ' * indent}{key}: {child}"


def print_dict(val, nesting: int = 0, **_compat):
    """Pretty-print a nested config mapping, one `key: value` per line;
    ``nesting`` is the starting indent in spaces. Non-dict input is printed
    as-is."""
    if not isinstance(val, dict):
        print(val)
        return
    print("\n".join(_dict_lines(val, max(nesting, 0))))
