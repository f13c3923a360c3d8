"""max_pool_roofline: percent of its roofline that the ``int8_features``
kernel ``max_pool`` reached: Σ bound ÷ Σ measured device time over the
launches the trace recorded.

A request launches one ``max_pool`` a pooling of ``run.shapes["pools"]``
(``c`` channels, ``hw`` → ``out_hw``), in order; a request whose trace
lost any of them drops from both sums.  The bound of a launch is its
bytes over the memory rate (a max is a compare an input): the float32
input once, ``B · c · hw²`` values, and the float32 output once, ``B ·
c · out_hw²``."""
import re

from bench.roofline import bound_s

MAX_POOL = re.compile(r"int8_features_max_pool_kernel")


def request_bound_s(shapes) -> float:
    return sum(bound_s(4.0 * shapes["batch"] * p["c"] * (
        p["hw"] ** 2 + p["out_hw"] ** 2), 0.0, "int8")
        for p in shapes["pools"])


def read(run):
    if run.trace is None or not run.shapes.get("pools"):
        return None
    n_pools = len(run.shapes["pools"])
    per_req = request_bound_s(run.shapes)
    groups = run.trace.by_group()
    bound = measured = 0.0
    for g in run.trace.in_groups("request"):
        launches = [o for o in groups.get(g, []) if MAX_POOL.search(o.name)]
        if len(launches) != n_pools:
            continue
        bound += per_req
        measured += sum(o.end - o.start for o in launches) / 1e6
    return 100.0 * bound / measured if measured > 0 else None
