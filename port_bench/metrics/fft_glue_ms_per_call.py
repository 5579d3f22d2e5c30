"""Device ms a traced call of the operations that are not the program's own
CUDA kernels and that an ``hst::fft.*`` span launched: ``fft/api``'s pads,
copies of strided views and spectrum pack / unpack (``port_bench.spans``)."""

from port_bench.spans import glue_ms_per_call


def read(run):
    return glue_ms_per_call(run, ("fft",))
