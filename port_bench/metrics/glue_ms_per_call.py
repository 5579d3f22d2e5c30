"""Device ms a call of the operations that are not the program's own CUDA
kernels (torch's element-wise kernels, copies and fills), by name in the
profiler's trace: a kernel is the program's where its name holds a
``__global__`` function of the program's CUDA sources."""

from port_bench.trace import is_port_kernel


def read(run):
    if run.trace is None or not run.trace.device_ops or not run.traced_calls:
        return None
    glue = sum(dur for name, _, dur in run.trace.device_ops
               if not is_port_kernel(name, run.port_kernels))
    return glue * 1e-3 / run.traced_calls
