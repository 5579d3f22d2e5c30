"""Device ms a traced call of the operations that are not the program's own
CUDA kernels and that an ``hst::entry.*`` or ``hst::engine.*`` span of the
program launched: the entries' and the engines' own torch glue (products,
sums, concatenations, copies), put down to the span by the launch's
correlation in the profiler's trace (``port_bench.spans``)."""

from port_bench.spans import glue_ms_per_call


def read(run):
    return glue_ms_per_call(run, ("entry", "engine"))
