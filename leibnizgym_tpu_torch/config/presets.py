"""Gym and agent presets and the CLI override parser (the JAX package's
``config/presets.py``, a module of plain dicts and yaml that imports no JAX)."""

from leibnizgym_tpu.config.presets import (  # noqa: F401
    GYM_PRESETS,
    default_config,
    parse_cli,
    rlg_asymm_config,
    update_cfg,
)
