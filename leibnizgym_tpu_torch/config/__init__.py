"""Config presets."""
