"""Synthetic token data of the port (numpy, as the reference draws it)."""

from repro_torch.data.pipeline import make_batch

__all__ = ["make_batch"]
