"""The least time the card could take for one call's work over the call's
device busy time in the profiler's trace, in %. The work is what the cell's
shapes make any implementation move and compute (the entry's ``work``);
the least time is the larger of its bytes at the HBM peak and its
operations at the FP32 peak (``port_bench.roofline``)."""

from port_bench.roofline import least_seconds


def read(run):
    if run.trace is None or not run.traced_calls:
        return None
    busy = run.trace.busy_s / run.traced_calls
    if busy <= 0:
        return None
    return 100.0 * least_seconds(*run.work)[0] / busy
