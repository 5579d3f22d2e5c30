from .api import (  # noqa: F401
    MAX_FFT_SIZE_LOG2,
    rfft,
    rifft,
    set_default_backend,
    get_default_backend,
)
