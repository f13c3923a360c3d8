"""lm_itl_p95_ms: 95th percentile over every gap between two consecutive
output tokens of every request, both inside the window (host clock, as
the client reads them), prefill stalls included."""
from bench.stats import percentile


def read(run):
    ms = run.samples.get("itl_ms")
    return percentile(ms, 95.0) if ms else None
