"""Operator tools of the port: ``python -m rio_tpu_torch.tools.<name>``."""
