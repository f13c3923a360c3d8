"""cnn_branch_launches: device operations a request launched on the host
inside a module's ``codr.branch`` spans: every branch's feature path,
convolutions, poolings and epilogues (the module input's features are
made inside its first branch).  What a fusion of the three 1×1
convolutions or of the branch epilogues would cut; placed by the
launch's host time (``cnn_pool_ms.launched_in``)."""
from bench import harness


def read(run):
    got = harness.load_module("metrics", "cnn_pool_ms").launched_in(
        run, "codr.branch")
    if got is None:
        return None
    ops, n = got
    return len(ops) / n
