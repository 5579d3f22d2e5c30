from . import mono, multichannel, offline, partial_tracker, partitioned, pipeline, time_domain  # noqa: F401
from .mono import LatencyMode, MonoConvolve, PartitionScheme  # noqa: F401
from .multichannel import Convolver  # noqa: F401
from .offline import FastFIR, choose_fft_size, fast_fir  # noqa: F401
from .partial_tracker import PartialTracker  # noqa: F401
from .partitioned import PartitionedConvolve, PartitionedState  # noqa: F401
from .time_domain import TimeDomainConvolve  # noqa: F401
