"""Config presets and CLI parsing."""

from leibnizgym_tpu_torch.config.presets import (
    GYM_PRESETS,
    RLG_PRESETS,
    default_config,
    parse_cli,
    update_cfg,
)

__all__ = ["GYM_PRESETS", "RLG_PRESETS", "default_config", "parse_cli", "update_cfg"]
