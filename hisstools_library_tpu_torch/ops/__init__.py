from . import spectral  # noqa: F401
from . import spectral_processor  # noqa: F401
from .spectral_processor import EdgeMode  # noqa: F401
