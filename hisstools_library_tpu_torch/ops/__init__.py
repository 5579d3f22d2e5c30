from . import interpolation, table_reader, windows  # noqa: F401
from . import spectral  # noqa: F401
from . import spectral_processor  # noqa: F401
from . import smoothing, statistics, stft  # noqa: F401
from .spectral_processor import EdgeMode  # noqa: F401
