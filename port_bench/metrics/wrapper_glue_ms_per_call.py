"""Device ms a traced call of the operations that are not the program's own
CUDA kernels and that an ``hst::kernel.*`` span launched: the fills and
copies the kernel wrappers make around their launches
(``port_bench.spans``)."""

from port_bench.spans import glue_ms_per_call


def read(run):
    return glue_ms_per_call(run, ("kernel",))
