"""TriFinger task environment."""
