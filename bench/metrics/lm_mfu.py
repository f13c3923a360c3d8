"""lm_mfu: percent of the bf16 peak that the whole step reached: 2 ×
parameters a token multiplies by (``bench.roofline
.mla_moe_params_per_token``) × tokens processed in the window (the
prompts prefilled and every output token after each request's first)
over the window's seconds over 989 TFLOP/s."""
from bench.roofline import PEAK_OPS


def read(run):
    per_tok = run.shapes.get("params_per_token")
    if not per_tok or "tokens_out" not in run.work:
        return None
    tokens = (run.work["prompt_tokens"] + run.work["tokens_out"]
              - run.work["first_tokens"])
    if tokens <= 0:
        return None
    return 100.0 * 2 * per_tok * tokens / run.window_s / PEAK_OPS["bf16"]
