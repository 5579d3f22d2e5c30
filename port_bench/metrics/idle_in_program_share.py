"""The share of the traced window, in %, in which no operation ran on the
device while the host was inside one of the program's ``hst::entry.*``
spans: the device waiting on the program's own host code, as against its
wait while the harness and the profiler run between calls
(``device_idle_share`` less this; ``port_bench.spans``)."""

from port_bench.spans import idle_in_program_share


def read(run):
    return idle_in_program_share(run)
