"""CoDR core of the port: the offline codec (packing, customized RLE,
UCR), the dataflow accounting, the NumPy SMM lane, the engine, the
backend registry, the spec → compile → run API, and the transformer
lane's packs (``codr_linear``) and accounting (``serving``,
``baselines``)."""
from repro_torch.core import dataflow, packing, rle, smm, ucr  # noqa: F401
from repro_torch.core import backends, engine, api  # noqa: F401  (after the codec)
