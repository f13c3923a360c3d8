"""cnn_idle_launch_ms: device-idle ms a request in which the host was
working but launched too slowly: the gaps between two consecutive device
operations of one request mark that no read explains and whose second
operation was launched inside one of the program's ``codr.*`` spans
(``cnn_idle_read_ms``'s ``idle_split``; host clock for the class, device
time for the gap)."""
from bench import harness


def read(run):
    split = harness.load_module("metrics", "cnn_idle_read_ms").idle_split(run)
    if split is None:
        return None
    return split["launch"] / 1e3 / split["requests"]
