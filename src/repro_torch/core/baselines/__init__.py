"""Baseline accelerators the paper compares against (SCNN [1], UCNN [5])
— the port's copy of ``repro.core.baselines``: both baselines'
weight-compression sizes, for the serving accounting."""
from repro_torch.core.baselines.scnn import scnn_compress_bits
from repro_torch.core.baselines.ucnn import ucnn_compress_bits

__all__ = ["scnn_compress_bits", "ucnn_compress_bits"]
