"""The 95th percentile over every call of the window of the call's span on
the device's timeline: a CUDA event recorded before its first launch to one
recorded after its last. The calls are dispatched ahead, so the span is the
call's own time on the device and not its wait in the queue."""

import numpy as np


def read(run):
    if not run.call_s:
        return None
    return float(np.percentile(np.asarray(run.call_s), 95.0)) * 1e3
