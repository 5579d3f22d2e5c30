"""Audio-file IO of the port: WAVE / AIFF / AIFC reading and writing
(:mod:`.audio_file`), the native PCM codec (:mod:`.native_codec`) and
constant-memory block streaming (:mod:`.streaming`). Copies of the JAX
package's ``io`` (which imports no jax), so the port imports nothing of that
package; file IO is host work, and blocks stay numpy arrays."""

from .audio_file import (  # noqa: F401
    BaseAudioFile,
    Endianness,
    Error,
    FileType,
    IAudioFile,
    NumberFormat,
    OAudioFile,
    PCMFormat,
    double_to_extended,
    extended_to_double,
    extract_errors_from_flags,
    find_bit_depth,
    find_number_format,
    get_error_string,
)
from .streaming import AudioBlockReader  # noqa: F401
