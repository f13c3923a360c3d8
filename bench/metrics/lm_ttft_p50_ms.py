"""lm_ttft_p50_ms: median over the requests whose first token came in the
window of the time from ``ContinuousBatcher.submit`` to that token:
admission and the eager prefill (host clock)."""
from bench.stats import median


def read(run):
    ms = run.samples.get("ttft_ms")
    return median(ms) if ms else None
