"""PyTorch/CUDA port of the CoDR reproduction (slice 1: CNN inference
from compressed weights).

Module paths mirror the JAX reference package one to one
(``repro.core.engine`` ↔ ``repro_torch.core.engine``).  The port imports
``torch`` and NumPy only — never JAX, never the reference package — and
runs on the card unless a caller passes ``device="cpu"``.  Entry point:
:mod:`repro_torch.api`.
"""
