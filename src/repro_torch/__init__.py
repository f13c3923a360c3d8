"""PyTorch/CUDA port of the CoDR reproduction: CNN inference from
compressed weights, dense-transformer serving from packed weights, and
the serving layer over both (the batch server and the continuous
batcher).

Module paths mirror the JAX reference package one to one
(``repro.core.engine`` ↔ ``repro_torch.core.engine``).  The port imports
``torch`` and NumPy only — never JAX, never the reference package — and
runs on the card unless a caller passes ``device="cpu"``.  Entry
points: :mod:`repro_torch.api` (``CompiledModel.serve``),
:mod:`repro_torch.models`, :mod:`repro_torch.core.batching`,
:mod:`repro_torch.launch.serve`.
"""
