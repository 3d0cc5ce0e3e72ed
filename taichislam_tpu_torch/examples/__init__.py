"""Runnable examples over the port: ``python -m
taichislam_tpu_torch.examples.<name>``."""
