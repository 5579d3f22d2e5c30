"""Utilities of the port: the random number generators (:mod:`.rng`), the
hot-swap cell (:mod:`.memory_swap`) and its native runtime
(:mod:`.native_rt`), profiling (:mod:`.profiling`), checkpoints
(:mod:`.checkpoint`), the serving loop (:mod:`.serving`) and per-stage SNR
reports (:mod:`.debug_stages`). The exports are those of the JAX package's
``utils``."""

from .rng import CMWC, RandomGenerator, device_gaussian, device_uniform, ltqnorm  # noqa: F401
from .memory_swap import MemorySwap, SpinLock, Handle  # noqa: F401
from .profiling import Timer, sync, trace, Roofline, convolve_roofline  # noqa: F401
from . import checkpoint  # noqa: F401
