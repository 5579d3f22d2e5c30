"""Device operations (kernels, copies, fills; the program's and torch's) a
call in the profiler's trace of the traced calls."""


def read(run):
    if run.trace is None or not run.trace.device_ops or not run.traced_calls:
        return None
    return len(run.trace.device_ops) / run.traced_calls
