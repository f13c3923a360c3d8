"""PyTorch/CUDA port of the CoDR reproduction: CNN inference from
compressed weights (slice 1) and dense-transformer serving from packed
weights (slice 2).

Module paths mirror the JAX reference package one to one
(``repro.core.engine`` ↔ ``repro_torch.core.engine``).  The port imports
``torch`` and NumPy only — never JAX, never the reference package — and
runs on the card unless a caller passes ``device="cpu"``.  Entry
points: :mod:`repro_torch.api`, :mod:`repro_torch.models`,
:mod:`repro_torch.launch.serve`.
"""
