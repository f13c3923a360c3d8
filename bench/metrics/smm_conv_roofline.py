"""smm_conv_roofline: percent of its roofline that ``smm_conv`` reached:
Σ bound ÷ Σ measured device time over the launches the trace recorded.

A request launches one ``smm_conv`` a layer, in layer order; a request
whose trace lost any of them drops from both sums.  The bound of a launch
is ``bench.roofline.bound_s`` over ``smm_conv_counts`` (int8 operations
on the int8 peak)."""
from bench.kernel_names import SMM_CONV
from bench.roofline import bound_s, smm_conv_counts


def request_bound_s(shapes) -> float:
    total = 0.0
    for layer, nz in zip(shapes["layers"], shapes["nonzero"]):
        ops, n_bytes = smm_conv_counts(
            batch=shapes["batch"], n_in=layer["n"], ri=layer["ri"],
            ci=layer["ci"], m=layer["m"], rk=layer["rk"], ck=layer["ck"],
            stride=layer["stride"], nonzero=nz,
            n_unique=shapes["n_unique"])
        total += bound_s(n_bytes, ops, "int8")
    return total


def read(run):
    if run.trace is None or not run.shapes.get("layers"):
        return None
    n_layers = len(run.shapes["layers"])
    per_req = request_bound_s(run.shapes)
    groups = run.trace.by_group()
    bound = measured = 0.0
    for g in run.trace.in_groups("request"):
        launches = [o for o in groups.get(g, []) if SMM_CONV.search(o.name)]
        if len(launches) != n_layers:
            continue
        bound += per_req
        measured += sum(o.end - o.start for o in launches) / 1e6
    return 100.0 * bound / measured if measured > 0 else None
