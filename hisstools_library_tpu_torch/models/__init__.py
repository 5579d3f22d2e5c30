from . import offline, partitioned  # noqa: F401
from .offline import FastFIR, choose_fft_size, fast_fir  # noqa: F401
from .partitioned import PartitionedConvolve  # noqa: F401
