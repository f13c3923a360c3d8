"""lm_tokens_per_s: output tokens streamed to all clients in the window
over the window's seconds (host clock, stamped as each client reads
them)."""
from bench.stats import rate


def read(run):
    if not run.work.get("tokens_out"):
        return None
    return rate(run.work["tokens_out"], run.window_s)
