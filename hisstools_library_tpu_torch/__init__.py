"""hisstools_library_tpu_torch: the PyTorch / NVIDIA Hopper port.

A second package beside ``hisstools_library_tpu`` (the JAX reference, which
it never imports), with the same layout and names:

- :mod:`.core`   split-complex types, packed-spectrum products, error codes
- :mod:`.fft`    packed real and complex FFTs; hand-written Hopper kernels
                 in ``fft/hopper_fft.py`` and ``fft/hopper_kernels.py``,
                 CUDA sources in ``csrc/``, built on first use by
                 :mod:`._build`
- :mod:`.ops`    the spectral layer (``ir_*`` functions, the spectral
                 processor: edge-mode convolution, ``change_phase``) and the
                 analysis ops (windows, table reader, interpolation, STFT,
                 kernel smoothing, statistics)
- :mod:`.models` FastFIR, the partitioned and mono engines, the multichannel
                 ``Convolver``, the time-domain head, the partial tracker and
                 the IR pipeline
- :mod:`.utils`  the random number generators, the hot-swap cell and its
                 native runtime, profiling, checkpoints, the serving loop
                 (``StreamingServer``) and per-stage SNR reports
- :mod:`.io`     audio files (WAVE / AIFF / AIFC), the native PCM codec and
                 constant-memory block streaming; native host libraries are
                 built on first use by :mod:`._native`

Kernels run on CUDA tensors; CPU tensors take each kernel's plain PyTorch
version.
"""

__version__ = "0.1.0"

from .core.types import Split  # noqa: F401
from .core.errors import ConvolveError, ConvolveException  # noqa: F401
