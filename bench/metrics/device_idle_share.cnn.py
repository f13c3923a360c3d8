"""device_idle_share.cnn: percent of the traced window in which no
operation ran on the device (CNN cells)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
