"""Runnable demos of the port: ``python -m rio_tpu_torch.examples.<name>``."""
