"""CoDR core of the port: the offline codec (packing, customized RLE,
UCR), the dataflow accounting and energy cost model, the NumPy SMM
lane, the engine, the backend registry, the spec → compile → run API,
the transformer lane's packs (``codr_linear``) and accounting
(``baselines``), and the serving layer (``serving``: the batch server;
``batching``: the continuous batcher)."""
from repro_torch.core import dataflow, cost_model, packing, rle, smm, ucr  # noqa: F401
from repro_torch.core import backends, engine, api  # noqa: F401  (after the codec)
