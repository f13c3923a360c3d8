"""lm_slot_occupancy: percent of the pooled step's slots that produced a
token: tokens from pooled steps in the window (every output token but
each request's first, which its prefill gives) over ``steps_run`` ×
``n_slots`` (the batcher's counters, read at the window's ends)."""


def read(run):
    steps = run.counters.get("steps_run")
    if not steps:
        return None
    pooled = run.work["tokens_out"] - run.work["first_tokens"]
    return 100.0 * pooled / (steps * run.counters["n_slots"])
