"""CoDR core of the port: the offline codec (packing, customized RLE,
UCR), the dataflow accounting, the NumPy SMM lane, the engine, the
backend registry, and the spec → compile → run API."""
from repro_torch.core import dataflow, packing, rle, smm, ucr  # noqa: F401
from repro_torch.core import backends, engine, api  # noqa: F401  (after the codec)
