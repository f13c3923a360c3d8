"""codr_matmul_roofline: percent of its roofline that ``codr_matmul``
reached in the captured pooled step: Σ bound ÷ Σ measured device time
over the replays the trace recorded whole.  A replay runs one launch a
packed projection of the step (``bench.roofline.mla_moe_step_matmuls``,
M = the pool's slots); a replay whose launches the trace did not all
record drops from both sums.  The eager prefill's launches are not
counted: the trace does not say their M."""
from bench.kernel_names import CODR_MATMUL
from bench.roofline import bound_s, codr_matmul_counts


def step_bound_s(shapes) -> float:
    """The least time of one step's ``codr_matmul`` launches."""
    total = 0.0
    for k, n in shapes["step_matmuls"]:
        ops, n_bytes = codr_matmul_counts(m=shapes["n_slots"], k=k, n=n,
                                          bits=shapes["bits"])
        total += bound_s(n_bytes, ops, "bf16")
    return total


def read(run):
    if run.trace is None or not run.shapes.get("step_matmuls"):
        return None
    per_step = step_bound_s(run.shapes)
    want = len(run.shapes["step_matmuls"])
    bound = measured = 0.0
    for rep in run.trace.replays():
        mm = [o for o in rep if CODR_MATMUL.search(o.name)]
        if len(mm) != want:
            continue
        bound += per_step
        measured += sum(o.end - o.start for o in mm) / 1e6
    return 100.0 * bound / measured if measured > 0 else None
