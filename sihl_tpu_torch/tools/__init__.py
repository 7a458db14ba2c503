"""Measurement scripts of the port, run as ``python -m sihl_tpu_torch.tools.<name>``."""
