"""cnn_host_enqueue_ms: median over the window's requests of the host time
from the first block's call to ``CompiledModel.run`` until the last
block's returns, before the synchronise: the entry and the engine chain
on the host (``core.api`` → backend ``run_model`` →
``core.engine.CodrModel``), a model a block, with the harness's pooling
launches between them."""
from bench.stats import median


def read(run):
    ms = run.samples.get("enqueue_ms")
    return median(ms) if ms else None
