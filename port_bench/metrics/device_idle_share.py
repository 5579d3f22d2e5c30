"""The share of the traced window, in %, in which no operation ran on the
device (from the profiler's trace)."""


def read(run):
    if run.trace is None or not run.trace.device_ops or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
