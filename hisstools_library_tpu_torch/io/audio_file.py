"""WAVE / AIFF / AIFC audio file reading and writing.

A copy of ``hisstools_library_tpu/io/audio_file.py`` (which imports no jax;
the port imports nothing of that package, whose ``__init__`` imports jax).

Counterpart of the reference AudioFile trio (AudioFile/BaseAudioFile.h,
IAudioFile.cpp, OAudioFile.cpp), re-designed as a host-side data loader: PCM
decoding is vectorised numpy (the per-sample byte-twiddling loops of
IAudioFile::readAudio :619-690 become array ops), and the result feeds
``torch.from_numpy`` / a host-to-device copy directly.

Coverage mirrors the reference:

- WAVE little-endian (RIFF) and big-endian (RIFX); PCM format tags 1 (int) and
  3 (float), plus WAVE_FORMAT_EXTENSIBLE resolving to either
- AIFF (always int16/24/32 big-endian) and AIFC with compression types
  NONE/twos (big-endian int), sowt (little-endian int), fl32/FL32, fl64/FL64,
  in24, in32, plus the AIFC version check (AIFC_CURRENT_SPECIFICATION,
  BaseAudioFile.h / IAudioFile.cpp:409-559)
- PCM formats int8 / int16 / int24 / int32 / float32 / float64
- 80-bit extended sample rates (extendedToDouble, IAudioFile.cpp:187-213;
  putExtended, OAudioFile.cpp:339)
- interleaved or single-channel reads/writes; single-channel writes into
  multichannel files read-modify-write the interleave (OAudioFile::writeAudio)
- error *flags* (bitfield accumulation) with string rendering, as in
  BaseAudioFile::getErrorString/extractErrorsFromFlags
"""

from __future__ import annotations

import enum
import struct
from typing import List, Optional, Tuple, Union

import numpy as np


class FileType(enum.Enum):
    NONE = 0
    AIFF = 1
    AIFC = 2
    WAVE = 3


class PCMFormat(enum.Enum):
    Int8 = 0
    Int16 = 1
    Int24 = 2
    Int32 = 3
    Float32 = 4
    Float64 = 5


class Endianness(enum.Enum):
    Little = 0
    Big = 1


class NumberFormat(enum.Enum):
    Int = 0
    Float = 1


class Error(enum.IntFlag):
    NONE = 0
    MEM_COULD_NOT_ALLOCATE = 1 << 0
    FILE_ERROR = 1 << 1
    FILE_COULDNT_OPEN = 1 << 2
    FILE_BAD_FORMAT = 1 << 3
    FILE_UNKNOWN_FORMAT = 1 << 4
    FILE_UNSUPPORTED_PCM_FORMAT = 1 << 5
    AIFC_WRONG_VERSION = 1 << 6
    AIFC_UNSUPPORTED_FORMAT = 1 << 7
    WAVE_UNSUPPORTED_FORMAT = 1 << 8
    FILE_COULDNT_WRITE = 1 << 9


AIFC_CURRENT_SPECIFICATION = 0xA2805140

_ERROR_STRINGS = {
    Error.MEM_COULD_NOT_ALLOCATE: "mem could not allocate",
    Error.FILE_ERROR: "file error",
    Error.FILE_COULDNT_OPEN: "file couldn't open",
    Error.FILE_BAD_FORMAT: "file bad format",
    Error.FILE_UNKNOWN_FORMAT: "file unknown format",
    Error.FILE_UNSUPPORTED_PCM_FORMAT: "file unsupported pcm format",
    Error.AIFC_WRONG_VERSION: "aifc wrong version",
    Error.AIFC_UNSUPPORTED_FORMAT: "aifc unsupported format",
    Error.WAVE_UNSUPPORTED_FORMAT: "wave unsupported format",
    Error.FILE_COULDNT_WRITE: "file couldn't write",
}


def get_error_string(error: Error) -> str:
    return _ERROR_STRINGS.get(error, "no error")


def extract_errors_from_flags(flags: int) -> List[Error]:
    return [e for e in Error if e != Error.NONE and flags & e]


_BIT_DEPTH = {
    PCMFormat.Int8: 8, PCMFormat.Int16: 16, PCMFormat.Int24: 24,
    PCMFormat.Int32: 32, PCMFormat.Float32: 32, PCMFormat.Float64: 64,
}


def find_bit_depth(fmt: PCMFormat) -> int:
    return _BIT_DEPTH[fmt]


def find_number_format(fmt: PCMFormat) -> NumberFormat:
    return NumberFormat.Float if fmt in (PCMFormat.Float32, PCMFormat.Float64) \
        else NumberFormat.Int


# -- 80-bit extended float ----------------------------------------------------------

def extended_to_double(b: bytes) -> float:
    """Decode an 80-bit IEEE extended (AIFF sample rate) — IAudioFile.cpp:187-213."""
    exponent = ((b[0] & 0x7F) << 8) | b[1]
    mantissa = int.from_bytes(b[2:10], "big")
    sign = -1.0 if (b[0] & 0x80) else 1.0
    if exponent == 0 and mantissa == 0:
        return 0.0
    if exponent == 0x7FFF:
        return sign * float("inf")
    return sign * mantissa * 2.0 ** (exponent - 16383 - 63)


def double_to_extended(value: float) -> bytes:
    """Encode a double as 80-bit extended (OAudioFile putExtended, :339)."""
    if value == 0.0:
        return b"\x00" * 10
    sign = 0x8000 if value < 0 else 0
    value = abs(value)
    import math
    m, e = math.frexp(value)  # value = m * 2^e with m in [0.5, 1)
    exponent = e + 16382
    mantissa = int(m * (1 << 64))
    return struct.pack(">H", sign | exponent) + mantissa.to_bytes(8, "big")


# -- PCM codecs (vectorised numpy) ---------------------------------------------------

USE_NATIVE_CODEC = True


def _decode_pcm(raw: bytes, fmt: PCMFormat, endianness: Endianness,
                dtype=np.float64, wave_uint8: bool = False) -> np.ndarray:
    """Bytes -> normalised float array. Ints left-justify to 32 bits then scale by
    2^-31 (reference u32ToOutput semantics). Uses the native C++ codec when
    available (io/native_codec.py), falling back to vectorised numpy."""
    if USE_NATIVE_CODEC:
        from . import native_codec
        out = native_codec.decode_pcm(raw, fmt.value,
                                      endianness == Endianness.Little, wave_uint8)
        if out is not None:
            return out.astype(dtype, copy=False)
    if wave_uint8 and fmt == PCMFormat.Int8:
        b = np.frombuffer(raw, np.uint8).astype(np.int32)
        return (((b - 128) << 24) * 2.0 ** -31).astype(dtype)
    bo = "<" if endianness == Endianness.Little else ">"
    if fmt == PCMFormat.Float32:
        return np.frombuffer(raw, bo + "f4").astype(dtype)
    if fmt == PCMFormat.Float64:
        return np.frombuffer(raw, bo + "f8").astype(dtype)
    if fmt == PCMFormat.Int8:
        # WAVE int8 is unsigned-offset; AIFF int8 is signed two's complement.
        # The reference reads via u8ToOutput with an XOR for WAVE (IAudioFile.cpp);
        # we branch on endianness context at the caller via `wave_uint8`.
        v = np.frombuffer(raw, np.int8).astype(np.int32) << 24
    elif fmt == PCMFormat.Int16:
        v = np.frombuffer(raw, bo + "i2").astype(np.int32) << 16
    elif fmt == PCMFormat.Int24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        if endianness == Endianness.Little:
            v = (b[:, 0].astype(np.uint32) << 8) | (b[:, 1].astype(np.uint32) << 16) \
                | (b[:, 2].astype(np.uint32) << 24)
        else:
            v = (b[:, 2].astype(np.uint32) << 8) | (b[:, 1].astype(np.uint32) << 16) \
                | (b[:, 0].astype(np.uint32) << 24)
        v = v.astype(np.int32)
    elif fmt == PCMFormat.Int32:
        v = np.frombuffer(raw, bo + "i4").astype(np.int32)
    else:
        raise ValueError(fmt)
    return (v * (2.0 ** -31)).astype(dtype)


def _round_half_away(v: np.ndarray) -> np.ndarray:
    """C round() semantics (half away from zero) — np.round is half-to-even,
    which encodes exact half-LSB samples 1 LSB below the reference."""
    return np.copysign(np.floor(np.abs(v) + 0.5), v)


def _encode_pcm(x: np.ndarray, fmt: PCMFormat, endianness: Endianness,
                wave_uint8: bool = False) -> bytes:
    """Normalised float array -> bytes (reference inputToU32/inputToU8,
    OAudioFile.cpp:562-583: scale by 2^(bits-1), C round(), clip)."""
    if USE_NATIVE_CODEC:
        from . import native_codec
        out = native_codec.encode_pcm(np.asarray(x, np.float64), fmt.value,
                                      endianness == Endianness.Little, wave_uint8)
        if out is not None:
            return out
    if wave_uint8 and fmt == PCMFormat.Int8:
        # Reference inputToU8: round AFTER the +128 offset, then clip [0,255].
        v = _round_half_away(np.asarray(x, np.float64) * 128.0 + 128.0)
        return np.clip(v, 0, 255).astype(np.uint8).tobytes()
    bo = "<" if endianness == Endianness.Little else ">"
    if fmt == PCMFormat.Float32:
        return np.asarray(x, bo + "f4").tobytes()
    if fmt == PCMFormat.Float64:
        return np.asarray(x, bo + "f8").tobytes()
    bits = find_bit_depth(fmt)
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    v = np.clip(_round_half_away(np.asarray(x, np.float64) * (1 << (bits - 1))),
                lo, hi)
    v = v.astype(np.int64)
    if fmt == PCMFormat.Int8:
        return v.astype(np.int8).tobytes()
    if fmt == PCMFormat.Int16:
        return v.astype(bo + "i2").tobytes()
    if fmt == PCMFormat.Int32:
        return v.astype(bo + "i4").tobytes()
    # Int24
    v32 = v.astype(np.int64) & 0xFFFFFF
    b = np.empty((len(v), 3), np.uint8)
    if endianness == Endianness.Little:
        b[:, 0] = v32 & 0xFF
        b[:, 1] = (v32 >> 8) & 0xFF
        b[:, 2] = (v32 >> 16) & 0xFF
    else:
        b[:, 2] = v32 & 0xFF
        b[:, 1] = (v32 >> 8) & 0xFF
        b[:, 0] = (v32 >> 16) & 0xFF
    return b.tobytes()


# -- base ---------------------------------------------------------------------------

class BaseAudioFile:
    def __init__(self):
        self.file_type = FileType.NONE
        self.pcm_format = PCMFormat.Int16
        self.header_endianness = Endianness.Little
        self.audio_endianness = Endianness.Little
        self.sampling_rate = 0.0
        self.channels = 0
        self.frames = 0
        self.pcm_offset = 0
        self.error_flags = int(Error.NONE)

    @property
    def bit_depth(self) -> int:
        return find_bit_depth(self.pcm_format)

    @property
    def byte_depth(self) -> int:
        return self.bit_depth // 8

    @property
    def frame_byte_count(self) -> int:
        return self.channels * self.byte_depth

    @property
    def number_format(self) -> NumberFormat:
        return find_number_format(self.pcm_format)

    def get_errors(self) -> List[Error]:
        return extract_errors_from_flags(self.error_flags)

    def get_is_error(self) -> bool:
        return self.error_flags != int(Error.NONE)

    def clear_error_flags(self):
        self.error_flags = int(Error.NONE)

    def _set_error(self, e: Error):
        self.error_flags |= int(e)


# -- reader -------------------------------------------------------------------------

class IAudioFile(BaseAudioFile):
    """Audio file reader (reference IAudioFile.cpp)."""

    def __init__(self, path: str):
        super().__init__()
        self._file = None
        self._position = 0  # frame position
        try:
            self._file = open(path, "rb")
        except OSError:
            self._set_error(Error.FILE_COULDNT_OPEN)
            return
        try:
            self._parse_header()
        except Exception:
            self._set_error(Error.FILE_BAD_FORMAT)

    # context manager
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    def is_open(self) -> bool:
        return self._file is not None

    def seek(self, position: int):
        self._position = position

    def get_position(self) -> int:
        return self._position

    # -- header parsing -------------------------------------------------------------

    def _parse_header(self):
        f = self._file
        head = f.read(12)
        if len(head) < 12:
            self._set_error(Error.FILE_BAD_FORMAT)
            return
        tag, subtype = head[:4], head[8:12]
        if tag == b"FORM" and subtype in (b"AIFF", b"AIFC"):
            self._parse_aiff(subtype)
        elif tag in (b"RIFF", b"RIFX") and subtype == b"WAVE":
            self._parse_wave(tag)
        else:
            self._set_error(Error.FILE_UNKNOWN_FORMAT)

    def _chunks(self, endian: str):
        """Iterate (tag, size, data_offset) over the chunk stream from byte 12."""
        f = self._file
        f.seek(12)
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return
            tag = hdr[:4]
            size = struct.unpack(endian + "I", hdr[4:8])[0]
            offset = f.tell()
            yield tag, size, offset
            f.seek(offset + size + (size & 1))

    def _parse_aiff(self, subtype: bytes):
        self.header_endianness = Endianness.Big
        self.audio_endianness = Endianness.Big
        self.file_type = FileType.AIFF if subtype == b"AIFF" else FileType.AIFC
        f = self._file
        fmt_valid = False
        for tag, size, offset in self._chunks(">"):
            if tag == b"FVER" and self.file_type == FileType.AIFC:
                f.seek(offset)
                version = struct.unpack(">I", f.read(4))[0]
                if version != AIFC_CURRENT_SPECIFICATION:
                    self._set_error(Error.AIFC_WRONG_VERSION)
                    return
            elif tag == b"COMM":
                f.seek(offset)
                data = f.read(size)
                self.channels = struct.unpack(">H", data[0:2])[0]
                self.frames = struct.unpack(">I", data[2:6])[0]
                bit_depth = struct.unpack(">H", data[6:8])[0]
                self.sampling_rate = extended_to_double(data[8:18])
                number_format = NumberFormat.Int
                if self.file_type == FileType.AIFC and size >= 22:
                    comp = data[18:22]
                    nf, endian, err = self._aifc_compression(comp, bit_depth)
                    if err:
                        self._set_error(err)
                        return
                    number_format = nf
                    self.audio_endianness = endian
                err = self._set_pcm_from_depth(bit_depth, number_format)
                if err:
                    self._set_error(err)
                    return
                fmt_valid = True
            elif tag == b"SSND":
                f.seek(offset)
                ssnd_offset = struct.unpack(">I", f.read(4))[0]
                f.read(4)  # block size
                self.pcm_offset = offset + 8 + ssnd_offset
        if not fmt_valid or self.channels < 1 or not self.sampling_rate > 0 \
                or (not self.pcm_offset and self.frames > 0):
            # A parseable header with zero channels / nonpositive rate is
            # still a malformed file; without this flag a later
            # read_interleaved would divide by the zero frame size. A missing
            # SSND chunk is legal only for zero-frame files (AIFF spec: SSND
            # is required when numSampleFrames > 0).
            self._set_error(Error.FILE_BAD_FORMAT)

    @staticmethod
    def _aifc_compression(tag: bytes, bit_depth: int
                          ) -> Tuple[NumberFormat, Endianness, Optional[Error]]:
        """AIFC compression type -> (number format, endianness)
        (reference getAIFCCompression)."""
        t = tag.lower()
        if t in (b"none", b"twos"):
            return NumberFormat.Int, Endianness.Big, None
        if t == b"sowt":
            return NumberFormat.Int, Endianness.Little, None
        if t in (b"fl32", b"fl64"):
            return NumberFormat.Float, Endianness.Big, None
        if t == b"in24":
            return NumberFormat.Int, Endianness.Big, None
        if t == b"in32":
            return NumberFormat.Int, Endianness.Big, None
        return NumberFormat.Int, Endianness.Big, Error.AIFC_UNSUPPORTED_FORMAT

    def _parse_wave(self, tag: bytes):
        endian = Endianness.Little if tag == b"RIFF" else Endianness.Big
        self.header_endianness = endian
        self.audio_endianness = endian
        self.file_type = FileType.WAVE
        bo = "<" if endian == Endianness.Little else ">"
        f = self._file
        fmt_valid = False
        data_size = 0
        for ctag, size, offset in self._chunks(bo):
            if ctag == b"fmt ":
                f.seek(offset)
                data = f.read(size)
                fmt_tag, channels, sr = struct.unpack(bo + "HHI", data[0:8])
                bit_depth = struct.unpack(bo + "H", data[14:16])[0]
                if fmt_tag == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                    fmt_tag = struct.unpack(bo + "H", data[24:26])[0]
                if fmt_tag not in (1, 3):
                    self._set_error(Error.WAVE_UNSUPPORTED_FORMAT)
                    return
                number_format = NumberFormat.Float if fmt_tag == 3 else NumberFormat.Int
                self.channels = channels
                self.sampling_rate = float(sr)
                err = self._set_pcm_from_depth(bit_depth, number_format)
                if err:
                    self._set_error(err)
                    return
                fmt_valid = True
            elif ctag == b"data":
                self.pcm_offset = offset
                data_size = size
        if not fmt_valid or not self.pcm_offset or self.channels < 1 \
                or not self.sampling_rate > 0:
            # See the AIFF parser: zero channels / nonpositive rate would
            # divide by zero in read_interleaved's frame math.
            self._set_error(Error.FILE_BAD_FORMAT)
            return
        self.frames = data_size // self.frame_byte_count if self.frame_byte_count else 0

    def _set_pcm_from_depth(self, bit_depth: int, nf: NumberFormat) -> Optional[Error]:
        table = {
            (8, NumberFormat.Int): PCMFormat.Int8,
            (16, NumberFormat.Int): PCMFormat.Int16,
            (24, NumberFormat.Int): PCMFormat.Int24,
            (32, NumberFormat.Int): PCMFormat.Int32,
            (32, NumberFormat.Float): PCMFormat.Float32,
            (64, NumberFormat.Float): PCMFormat.Float64,
        }
        fmt = table.get((bit_depth, nf))
        if fmt is None:
            return Error.FILE_UNSUPPORTED_PCM_FORMAT
        self.pcm_format = fmt
        return None

    # -- audio reads ----------------------------------------------------------------

    def read_interleaved(self, num_frames: Optional[int] = None,
                         dtype=np.float64) -> np.ndarray:
        """Read interleaved frames from the current position: (frames, channels)."""
        if not self.is_open() or self.get_is_error():
            return np.zeros((0, max(self.channels, 1)), dtype)
        if num_frames is None:
            num_frames = self.frames - self._position
        num_frames = max(0, min(num_frames, self.frames - self._position))
        f = self._file
        f.seek(self.pcm_offset + self._position * self.frame_byte_count)
        raw = f.read(num_frames * self.frame_byte_count)
        got = len(raw) // self.frame_byte_count
        raw = raw[: got * self.frame_byte_count]
        # WAVE 8-bit PCM is unsigned-offset.
        wave_uint8 = (self.file_type == FileType.WAVE
                      and self.pcm_format == PCMFormat.Int8)
        x = _decode_pcm(raw, self.pcm_format, self.audio_endianness, dtype,
                        wave_uint8)
        self._position += got
        return x.reshape(got, self.channels)

    def read_raw(self, num_frames: Optional[int] = None) -> bytes:
        """Undecoded PCM frame bytes from the current position (reference
        readRaw, IAudioFile.h:48): ``got * frame_byte_count`` bytes in the
        file's own sample format and endianness; advances the position."""
        if not self.is_open() or self.get_is_error():
            return b""
        if num_frames is None:
            num_frames = self.frames - self._position
        num_frames = max(0, min(num_frames, self.frames - self._position))
        f = self._file
        f.seek(self.pcm_offset + self._position * self.frame_byte_count)
        raw = f.read(num_frames * self.frame_byte_count)
        got = len(raw) // self.frame_byte_count
        self._position += got
        return raw[: got * self.frame_byte_count]

    def read_channel(self, channel: int, num_frames: Optional[int] = None,
                     dtype=np.float64) -> np.ndarray:
        """Read one channel (reference readChannel): (frames,)."""
        x = self.read_interleaved(num_frames, dtype)
        return x[:, channel]


# -- writer -------------------------------------------------------------------------

class OAudioFile(BaseAudioFile):
    """Audio file writer (reference OAudioFile.cpp): WAVE (little or big endian
    header) or AIFC; header sizes/frame counts update on every write."""

    def __init__(self, path: str, file_type: FileType, pcm_format: PCMFormat,
                 channels: int, sampling_rate: float,
                 endianness: Endianness = Endianness.Little):
        super().__init__()
        # AIFF and NONE both write an AIFC container (reference
        # OAudioFile.cpp:55 maps AIFF->AIFC and the header branch at :64
        # writes AIFC for everything non-WAVE).
        if file_type in (FileType.AIFF, FileType.NONE):
            file_type = FileType.AIFC
        self.file_type = file_type
        self.pcm_format = pcm_format
        self.channels = channels
        self.sampling_rate = float(sampling_rate)
        # Everything non-WAVE is big-endian (reference OAudioFile.cpp:57);
        # an AIFC NONE-compression tag with little-endian payload would be
        # silent byte-swapped corruption.
        if file_type != FileType.WAVE:
            endianness = Endianness.Big
        self.header_endianness = endianness
        self.audio_endianness = endianness
        self._position = 0
        try:
            self._file = open(path, "w+b")
        except OSError:
            self._file = None
            self._set_error(Error.FILE_COULDNT_OPEN)
            return
        if file_type == FileType.WAVE:
            self._write_wave_header()
        else:
            self._write_aifc_header()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._file:
            self._update_header()
            self._file.close()
            self._file = None

    def is_open(self) -> bool:
        return self._file is not None

    def seek(self, position: int):
        self._position = min(position, self.frames)

    def get_position(self) -> int:
        return self._position

    # -- headers ---------------------------------------------------------------------

    def _write_wave_header(self):
        bo = "<" if self.header_endianness == Endianness.Little else ">"
        f = self._file
        f.seek(0)
        riff = b"RIFF" if self.header_endianness == Endianness.Little else b"RIFX"
        fmt_tag = 3 if self.number_format == NumberFormat.Float else 1
        byte_rate = int(self.sampling_rate) * self.frame_byte_count
        f.write(riff + struct.pack(bo + "I", 36) + b"WAVE")
        f.write(b"fmt " + struct.pack(bo + "I", 16))
        f.write(struct.pack(bo + "HHIIHH", fmt_tag, self.channels,
                            int(self.sampling_rate), byte_rate,
                            self.frame_byte_count, self.bit_depth))
        f.write(b"data" + struct.pack(bo + "I", 0))
        self.pcm_offset = f.tell()

    def _aifc_compression_tag(self) -> Tuple[bytes, bytes]:
        if self.pcm_format == PCMFormat.Float32:
            return b"fl32", b"32-bit floating point"
        if self.pcm_format == PCMFormat.Float64:
            return b"fl64", b"64-bit floating point"
        return b"NONE", b"not compressed"

    @staticmethod
    def _pstring(s: bytes) -> bytes:
        out = bytes([len(s)]) + s
        if len(out) & 1:
            out += b"\x00"
        return out

    def _write_aifc_header(self):
        f = self._file
        f.seek(0)
        comp_tag, comp_str = self._aifc_compression_tag()
        comm_body = (struct.pack(">HIH", self.channels, 0, self.bit_depth)
                     + double_to_extended(self.sampling_rate)
                     + comp_tag + self._pstring(comp_str))
        f.write(b"FORM" + struct.pack(">I", 0) + b"AIFC")
        f.write(b"FVER" + struct.pack(">II", 4, AIFC_CURRENT_SPECIFICATION))
        f.write(b"COMM" + struct.pack(">I", len(comm_body)) + comm_body)
        f.write(b"SSND" + struct.pack(">III", 8, 0, 0))
        self.pcm_offset = f.tell()
        self._comm_offset = 12 + 12 + 8  # FORM hdr + FVER chunk + COMM hdr

    def _update_header(self):
        """Update size/frame-count fields after writes (reference updateHeader,
        OAudioFile.cpp:483-521: only when the frame count grew — rewriting
        unchanged fields on every small streamed write is pure seek traffic)."""
        if not self._file:
            return
        if getattr(self, "_header_frames", -1) == self.frames:
            return
        f = self._file
        data_bytes = self.frames * self.frame_byte_count
        pad = data_bytes & 1
        if pad:
            # The chunk sizes below account for the IFF pad byte on odd-sized
            # data — it must actually exist in the file (reference
            # putPadByte, OAudioFile.cpp:494) or the declared size overruns
            # EOF by one byte for strict parsers.
            f.seek(self.pcm_offset + data_bytes)
            f.write(b"\x00")
        if self.file_type == FileType.WAVE:
            bo = "<" if self.header_endianness == Endianness.Little else ">"
            f.seek(4)
            f.write(struct.pack(bo + "I", 36 + data_bytes + pad))
            f.seek(self.pcm_offset - 4)
            f.write(struct.pack(bo + "I", data_bytes))
        else:
            f.seek(4)
            f.write(struct.pack(">I", self.pcm_offset - 8 + data_bytes + pad))
            f.seek(self._comm_offset + 2)
            f.write(struct.pack(">I", self.frames))
            f.seek(self.pcm_offset - 12)
            f.write(struct.pack(">I", 8 + data_bytes))
        self._header_frames = self.frames
        f.seek(self.pcm_offset + self._position * self.frame_byte_count)

    # -- audio writes ----------------------------------------------------------------

    def write_interleaved(self, x: np.ndarray):
        """Write (frames, channels) [or (frames,) for mono] from the current
        position."""
        if not self.is_open():
            return
        x = np.asarray(x, np.float64)
        if x.ndim == 1:
            x = x[:, None]
        n = x.shape[0]
        if x.shape[1] != self.channels:
            raise ValueError(f"expected {self.channels} channels, got {x.shape[1]}")
        wave_uint8 = (self.file_type == FileType.WAVE
                      and self.pcm_format == PCMFormat.Int8)
        raw = _encode_pcm(x.reshape(-1), self.pcm_format, self.audio_endianness,
                          wave_uint8)
        f = self._file
        f.seek(self.pcm_offset + self._position * self.frame_byte_count)
        f.write(raw)
        self._position += n
        self.frames = max(self.frames, self._position)
        self._update_header()

    def write_raw(self, raw: bytes):
        """Write pre-encoded PCM frame bytes from the current position
        (reference writeRaw, OAudioFile.h:30): ``raw`` must be whole frames
        in the file's own sample format and endianness — pairs with
        :meth:`IAudioFile.read_raw` for decode-free copying."""
        if not self.is_open():
            return
        if len(raw) % self.frame_byte_count:
            raise ValueError(f"raw length {len(raw)} is not a multiple of the "
                             f"frame size {self.frame_byte_count}")
        n = len(raw) // self.frame_byte_count
        f = self._file
        f.seek(self.pcm_offset + self._position * self.frame_byte_count)
        f.write(raw)
        self._position += n
        self.frames = max(self.frames, self._position)
        self._update_header()

    def write_channel(self, channel: int, x: np.ndarray):
        """Write one channel into an interleaved file (read-modify-write of the
        existing interleave, reference writeAudio channel path)."""
        if not self.is_open():
            return
        x = np.asarray(x, np.float64).reshape(-1)
        n = len(x)
        f = self._file
        start = self._position
        # read existing frames (zero-extend)
        f.seek(self.pcm_offset + start * self.frame_byte_count)
        avail = max(0, self.frames - start)
        take = min(avail, n)
        raw = f.read(take * self.frame_byte_count)
        wave_uint8 = (self.file_type == FileType.WAVE
                      and self.pcm_format == PCMFormat.Int8)
        cur = _decode_pcm(raw, self.pcm_format, self.audio_endianness,
                          wave_uint8=wave_uint8)
        frames = np.zeros((n, self.channels))
        if take:
            frames[:take] = cur.reshape(take, self.channels)
        frames[:, channel] = x
        self.write_interleaved(frames)
