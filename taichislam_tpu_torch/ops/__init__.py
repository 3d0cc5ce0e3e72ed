"""Fusion and ESDF operations on PyTorch tensors."""
