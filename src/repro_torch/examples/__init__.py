"""Runnable examples of the port's public API (``python -m repro_torch.examples.<name>``)."""
