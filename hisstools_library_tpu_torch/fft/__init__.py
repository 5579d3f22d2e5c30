from .api import (  # noqa: F401
    MAX_FFT_SIZE_LOG2,
    fft,
    ifft,
    rfft,
    rfft_padded,
    rifft,
    unzip,
    zip_split,
    unzip_zero,
    pack_spectrum,
    unpack_spectrum,
    set_default_backend,
    get_default_backend,
)
from .df64 import fft_df64, rfft_df64, rifft_df64  # noqa: F401
