"""Command-line entry points of the port: ``python -m
pmce_tpu_torch.main.train`` and ``python -m pmce_tpu_torch.main.test``."""
