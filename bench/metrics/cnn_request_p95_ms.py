"""cnn_request_p95_ms: 95th percentile over every request of the window,
from the call to ``CompiledModel.run`` to the device synchronise that
ends it (host clock)."""
from bench.stats import percentile


def read(run):
    ms = run.samples.get("request_ms")
    return percentile(ms, 95.0) if ms else None
