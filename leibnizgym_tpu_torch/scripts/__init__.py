"""Command-line entry points of the port (``python -m leibnizgym_tpu_torch.scripts.<name>``)."""
