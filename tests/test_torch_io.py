"""Port parity: audio-file IO (io/audio_file.py, io/native_codec.py built
into the port's own build directory, io/streaming.py).

The twins of ``tests/test_audio_file.py``, ``tests/test_audio_file_robustness.py``,
``tests/test_io_streaming.py`` and ``tests/test_native_codec.py``, with their
repeated cases merged into parametrised ones: round trips across formats,
cross-checks with scipy, 80-bit extended rates, the error-flag contract on
malformed files, block streaming through the Python path and the native
loader + codec, and the native codec's bit-exact parity with numpy. Besides:

- a file written by either package's ``OAudioFile`` reads back
  bit-identical through the other's ``IAudioFile``;
- a WAV streamed through ``AudioBlockReader`` into the port's
  ``mono.process_any`` matches the port's offline ``FastFIR`` at > 90 dB SNR
  and a float64 convolution at > 90 dB (the JAX test's bar).
"""

import os
import struct
import time

import numpy as np
import pytest
import scipy.io.wavfile

torch = pytest.importorskip("torch")

import hisstools_library_tpu.io as jio  # noqa: E402
from hisstools_library_tpu_torch import _native  # noqa: E402
from hisstools_library_tpu_torch.io import (  # noqa: E402
    Endianness, Error, FileType, IAudioFile, OAudioFile, PCMFormat, audio_file as af,
    double_to_extended, extended_to_double, extract_errors_from_flags, get_error_string,
    native_codec)
from hisstools_library_tpu_torch.io.streaming import AudioBlockReader  # noqa: E402
from hisstools_library_tpu_torch.models import mono  # noqa: E402
from hisstools_library_tpu_torch.models.offline import FastFIR  # noqa: E402
from hisstools_library_tpu_torch.utils import native_rt  # noqa: E402

CPU = "cpu"  # the port builds on the card unless a call names the CPU

TOL = {
    PCMFormat.Int8: 2 ** -7,
    PCMFormat.Int16: 2 ** -15,
    PCMFormat.Int24: 2 ** -23,
    PCMFormat.Int32: 2 ** -30,
    PCMFormat.Float32: 1e-7,
    PCMFormat.Float64: 0.0,
}
CONTAINERS = [(FileType.WAVE, Endianness.Little), (FileType.WAVE, Endianness.Big),
              (FileType.AIFC, Endianness.Big)]


def make_signal(rng, frames, channels):
    return np.clip(rng.standard_normal((frames, channels)) * 0.3, -0.999, 0.999)


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


@pytest.fixture
def native_loader():
    if not (native_rt.available() and native_codec.available()):
        pytest.skip("native runtime / codec unavailable (no g++)")


@pytest.fixture
def lib():
    lib = native_codec.load()
    if lib is None:
        pytest.skip("native codec unavailable (no g++?)")
    return lib


# -- audio_file ------------------------------------------------------------------

@pytest.mark.parametrize("fmt", list(PCMFormat))
@pytest.mark.parametrize("ftype,endian", CONTAINERS)
def test_roundtrip(tmp_path, rng, fmt, ftype, endian):
    path = str(tmp_path / "t.bin")
    x = make_signal(rng, 277, 3)
    with OAudioFile(path, ftype, fmt, 3, 44100.0, endian) as out:
        assert not out.get_is_error(), out.get_errors()
        out.write_interleaved(x)
    with IAudioFile(path) as inp:
        assert not inp.get_is_error(), inp.get_errors()
        assert (inp.channels, inp.frames, inp.sampling_rate) == (3, 277, 44100.0)
        assert inp.pcm_format == fmt
        y = inp.read_interleaved()
    assert y.shape == x.shape
    assert np.abs(y - x).max() <= TOL[fmt] * 1.01


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", list(PCMFormat))
@pytest.mark.parametrize("ftype,endian", CONTAINERS)
def test_cross_package_bit_identical(tmp_path, rng, writer, fmt, ftype, endian):
    """A file written by either package reads back bit-identical through the
    other's reader, and the two writers produce the same bytes."""
    x = make_signal(rng, 101, 2)
    paths = {}
    jax_args = (jio.FileType[ftype.name], jio.PCMFormat[fmt.name], 2, 48000.0,
                jio.Endianness[endian.name])
    for name, cls, args in (("jax", jio.OAudioFile, jax_args),
                            ("port", OAudioFile, (ftype, fmt, 2, 48000.0, endian))):
        paths[name] = str(tmp_path / f"{name}.bin")
        with cls(paths[name], *args) as out:
            out.write_interleaved(x)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    with jio.IAudioFile(paths[writer]) as f:
        yj = f.read_interleaved()
    with IAudioFile(paths[writer]) as f:
        yt = f.read_interleaved()
    assert yj.dtype == yt.dtype
    np.testing.assert_array_equal(yj, yt)


def test_wave_scipy_interop_write(tmp_path, rng):
    path = str(tmp_path / "t.wav")
    x = make_signal(rng, 100, 2)
    with OAudioFile(path, FileType.WAVE, PCMFormat.Int16, 2, 48000.0) as out:
        out.write_interleaved(x)
    sr, y = scipy.io.wavfile.read(path)
    assert sr == 48000
    assert np.abs(y / 32768.0 - x).max() < 2 ** -15 * 1.01


@pytest.mark.parametrize("fmt", ["int16", "float32"])
def test_wave_scipy_interop_read(tmp_path, rng, fmt):
    path = str(tmp_path / "t.wav")
    if fmt == "int16":
        x = (make_signal(rng, 64, 1)[:, 0] * 32767).astype(np.int16)
        scipy.io.wavfile.write(path, 22050, x)
        ref, tol = x / 32768.0, 1e-9
    else:
        x = make_signal(rng, 50, 1)[:, 0].astype(np.float32)
        scipy.io.wavfile.write(path, 8000, x)
        ref, tol = x.astype(np.float64), 1e-7
    with IAudioFile(path) as inp:
        assert inp.channels == 1
        assert inp.pcm_format == (PCMFormat.Int16 if fmt == "int16" else PCMFormat.Float32)
        y = inp.read_channel(0)
    assert np.abs(y - ref).max() < tol


def test_seek_and_partial_reads(tmp_path, rng):
    path = str(tmp_path / "t.wav")
    x = make_signal(rng, 200, 2)
    with OAudioFile(path, FileType.WAVE, PCMFormat.Float64, 2, 96000.0) as out:
        out.write_interleaved(x)
    with IAudioFile(path) as inp:
        inp.seek(50)
        y = inp.read_interleaved(25)
        assert np.array_equal(y, x[50:75])
        assert inp.get_position() == 75
        assert inp.read_interleaved(1000).shape[0] == 125  # clamped to remaining


def test_write_channel_rmw(tmp_path, rng):
    path = str(tmp_path / "t.wav")
    x = make_signal(rng, 80, 3)
    with OAudioFile(path, FileType.WAVE, PCMFormat.Float64, 3, 44100.0) as out:
        out.write_interleaved(x)
        out.seek(0)
        newch = make_signal(rng, 80, 1)[:, 0]
        out.write_channel(1, newch)
    with IAudioFile(path) as inp:
        y = inp.read_interleaved()
    assert np.allclose(y[:, 0], x[:, 0])
    assert np.allclose(y[:, 1], newch)
    assert np.allclose(y[:, 2], x[:, 2])


@pytest.mark.parametrize("value", [44100.0, 48000.0, 22050.5, 96000.0, 8000.0, 1.0, 0.0])
def test_extended_float_roundtrip(value):
    assert extended_to_double(double_to_extended(value)) == value


def test_bad_file_errors(tmp_path):
    path = str(tmp_path / "bad.wav")
    with open(path, "wb") as f:
        f.write(b"not an audio file at all....")
    assert IAudioFile(path).get_is_error()
    assert IAudioFile(str(tmp_path / "missing.wav")).get_is_error()


def test_error_strings():
    flags = int(Error.FILE_BAD_FORMAT | Error.AIFC_WRONG_VERSION)
    errs = extract_errors_from_flags(flags)
    assert Error.FILE_BAD_FORMAT in errs and Error.AIFC_WRONG_VERSION in errs
    assert get_error_string(Error.FILE_BAD_FORMAT) == "file bad format"


def test_aifc_mono_float64(tmp_path, rng):
    path = str(tmp_path / "t.aifc")
    x = make_signal(rng, 33, 1)
    with OAudioFile(path, FileType.AIFC, PCMFormat.Float64, 1, 44100.0) as out:
        out.write_interleaved(x)
    with IAudioFile(path) as inp:
        assert inp.file_type == FileType.AIFC
        assert np.array_equal(inp.read_interleaved(), x)


def test_odd_data_chunk_pad_byte(tmp_path):
    """Odd-sized PCM data is followed by the IFF pad byte the declared
    RIFF/FORM sizes account for (reference putPadByte, OAudioFile.cpp:494)."""
    path = str(tmp_path / "odd.wav")
    with OAudioFile(path, FileType.WAVE, PCMFormat.Int8, 1, 44100.0) as f:
        f.write_interleaved(np.zeros((3, 1)))
    with open(path, "rb") as fh:
        riff_size = struct.unpack("<I", fh.read(8)[4:])[0]
    assert os.path.getsize(path) == riff_size + 8
    with IAudioFile(path) as f:
        assert f.frames == 3 and not f.get_is_error()


def test_zero_frame_aiff_without_ssnd(tmp_path):
    """An AIFF with numSampleFrames == 0 and no SSND chunk is legal."""
    comm = struct.pack(">HIH", 1, 0, 16) + double_to_extended(44100.0)
    body = b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
    path = str(tmp_path / "empty.aif")
    with open(path, "wb") as fh:
        fh.write(b"FORM" + struct.pack(">I", len(body)) + body)
    with IAudioFile(path) as f:
        assert not f.get_is_error(), f.get_errors()
        assert f.frames == 0 and f.channels == 1
        assert f.read_interleaved().shape[0] == 0


@pytest.mark.parametrize("fmt,ftype", [(PCMFormat.Int8, FileType.WAVE),
                                       (PCMFormat.Int16, FileType.WAVE),
                                       (PCMFormat.Int16, FileType.AIFF)])
def test_half_lsb_rounds_away_from_zero(tmp_path, fmt, ftype):
    """Exact half-LSB samples encode with C round() semantics (reference
    inputToU32/inputToU8); the WAVE uint8 path offsets before rounding."""
    scale = 1 << ({PCMFormat.Int8: 8, PCMFormat.Int16: 16}[fmt] - 1)
    x = np.array([[0.5 / scale], [1.5 / scale], [-0.5 / scale]])
    path = str(tmp_path / ("half.wav" if ftype == FileType.WAVE else "half.aif"))
    with OAudioFile(path, ftype, fmt, 1, 48000.0) as f:
        f.write_interleaved(x)
    with IAudioFile(path) as f:
        got = np.round(f.read_interleaved()[:, 0] * scale).astype(int)
    expect_neg = 0 if fmt == PCMFormat.Int8 and ftype == FileType.WAVE else -1
    assert got.tolist() == [1, 2, expect_neg], got


def test_write_file_type_none_produces_valid_aifc(tmp_path, rng):
    path = str(tmp_path / "none.aiff")
    x = rng.uniform(-0.9, 0.9, (64, 2))
    with OAudioFile(path, FileType.NONE, PCMFormat.Int16, 2, 48000.0) as f:
        assert f.file_type == FileType.AIFC
        assert f.audio_endianness == Endianness.Big
        f.write_interleaved(x)
    with IAudioFile(path) as f:
        assert not f.error_flags
        assert np.abs(f.read_interleaved() - x).max() < 2.0 ** -15


def test_read_raw_and_raw_copy(tmp_path, rng):
    """read_raw returns the file's own PCM bytes (reference readRaw) and
    read_raw -> write_raw copies a file bit-exactly without decoding."""
    src_p, dst_p = str(tmp_path / "src.wav"), str(tmp_path / "dst.wav")
    x = rng.uniform(-0.9, 0.9, (123, 2))
    with OAudioFile(src_p, FileType.WAVE, PCMFormat.Int24, 2, 44100.0) as f:
        f.write_interleaved(x)
    with IAudioFile(src_p) as src:
        src.seek(10)
        raw = src.read_raw(20)
        assert len(raw) == 20 * src.frame_byte_count and src.get_position() == 30
        src.seek(0)
        with OAudioFile(dst_p, FileType.WAVE, PCMFormat.Int24, 2, 44100.0) as dst:
            while True:
                raw = src.read_raw(32)
                if not raw:
                    break
                dst.write_raw(raw)
            with pytest.raises(ValueError):
                dst.write_raw(b"x")  # not a whole frame
    with IAudioFile(src_p) as a, IAudioFile(dst_p) as b:
        assert b.frames == a.frames
        np.testing.assert_array_equal(a.read_interleaved(), b.read_interleaved())


# -- robustness ---------------------------------------------------------------------

def _valid_file(tmp_path, ftype, name):
    x = (0.1 * np.sin(np.arange(300) / 10.0))[None, :]
    path = str(tmp_path / name)
    with OAudioFile(path, ftype, PCMFormat.Int16, 1, 48000.0) as f:
        f.write_interleaved(x.T)
    return path, open(path, "rb").read()


def _check(path):
    """The robustness contract: open + read never raise."""
    f = IAudioFile(path)
    if not f.get_is_error():
        assert f.read_interleaved().ndim == 2
    else:
        for e in f.get_errors():
            assert isinstance(get_error_string(e), str)
    f.close()
    return f


@pytest.mark.parametrize("case,mutate,expect", [
    ("empty", lambda b: b"", Error.FILE_BAD_FORMAT),
    ("short", lambda b: b[:8], Error.FILE_BAD_FORMAT),
    ("bad_magic", lambda b: b"XXXX" + b[4:], Error.FILE_UNKNOWN_FORMAT),
    ("bad_subtype", lambda b: b[:8] + b"QQQQ" + b[12:], Error.FILE_UNKNOWN_FORMAT),
    ("truncated_header", lambda b: b[:20], Error.FILE_BAD_FORMAT),
    ("zero_channels", lambda b: b[:22] + b"\x00\x00" + b[24:], Error.FILE_BAD_FORMAT),
    ("bad_bit_depth", lambda b: b[:34] + b"\x07\x00" + b[36:],
     Error.FILE_UNSUPPORTED_PCM_FORMAT),
    ("oversized_chunk", lambda b: b[:16] + b"\xff\xff\xff\x7f" + b[20:],
     Error.FILE_BAD_FORMAT),
])
def test_crafted_wave_corruptions(tmp_path, case, mutate, expect):
    _, raw = _valid_file(tmp_path, FileType.WAVE, "ok.wav")
    p = str(tmp_path / f"{case}.wav")
    with open(p, "wb") as fh:
        fh.write(mutate(raw))
    assert expect in _check(p).get_errors()


def test_truncated_data_reads_available_frames(tmp_path):
    _, raw = _valid_file(tmp_path, FileType.WAVE, "ok.wav")
    p = str(tmp_path / "trunc.wav")
    with open(p, "wb") as fh:
        fh.write(raw[: len(raw) // 2])
    f = IAudioFile(p)
    assert not f.get_is_error()
    assert 0 < f.read_interleaved().shape[0] < 300


@pytest.mark.parametrize("ftype,name", [(FileType.WAVE, "f.wav"), (FileType.AIFC, "f.aifc")])
def test_random_corruption_fuzz(tmp_path, ftype, name, rng):
    """200 random corruptions + truncations per format: the open/read
    contract holds for every one."""
    _, raw = _valid_file(tmp_path, ftype, name)
    for trial in range(200):
        buf = bytearray(raw)
        for _ in range(int(rng.integers(1, 5))):
            buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            buf = buf[: int(rng.integers(0, len(buf)))]
        p = str(tmp_path / f"fuzz_{trial}{name[-5:]}")
        with open(p, "wb") as fh:
            fh.write(bytes(buf))
        _check(p)


def test_zero_channel_aiff_flags(tmp_path):
    _, raw = _valid_file(tmp_path, FileType.AIFF, "ok.aif")
    idx = raw.index(b"COMM") + 8
    p = str(tmp_path / "zc.aif")
    with open(p, "wb") as fh:
        fh.write(raw[:idx] + b"\x00\x00" + raw[idx + 2:])
    assert Error.FILE_BAD_FORMAT in _check(p).get_errors()


# -- block streaming -----------------------------------------------------------------

def _write(tmp_path, name, x, file_type=FileType.WAVE, fmt=PCMFormat.Float32,
           sr=48000.0):
    path = str(tmp_path / name)
    with OAudioFile(path, file_type, fmt, x.shape[0], sr) as f:
        f.write_interleaved(x.T)
    return path


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("fmt,ftype", [(PCMFormat.Int16, FileType.WAVE),
                                       (PCMFormat.Int24, FileType.WAVE),
                                       (PCMFormat.Float32, FileType.WAVE),
                                       (PCMFormat.Float64, FileType.WAVE),
                                       (PCMFormat.Int16, FileType.AIFF)])
def test_block_reader_parity(tmp_path, native, fmt, ftype, rng, request):
    if native:
        request.getfixturevalue("native_loader")
    x = 0.4 * rng.standard_normal((3, 23456))
    path = _write(tmp_path, "t.wav" if ftype == FileType.WAVE else "t.aif", x, ftype, fmt)
    with IAudioFile(path) as f:
        full = f.read_interleaved()
    with AudioBlockReader(path, 4096, native=native, dtype=np.float64) as r:
        blocks = list(r)
        assert len(blocks) == len(r)
    assert blocks[-1].shape[0] == 23456 % 4096  # short final block
    np.testing.assert_array_equal(np.concatenate(blocks, axis=0), full)


@pytest.mark.parametrize("native", [False, True])
def test_block_reader_truncated_file(tmp_path, native, rng, request):
    """A file cut mid-frame yields the whole frames that exist."""
    if native:
        request.getfixturevalue("native_loader")
    path = _write(tmp_path, "t.wav", 0.4 * rng.standard_normal((2, 5000)),
                  FileType.WAVE, PCMFormat.Int16)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4003)  # not a multiple of the frame
    with AudioBlockReader(path, 1024, native=native, dtype=np.float64) as r:
        blocks = list(r)
    y = np.concatenate(blocks, axis=0) if blocks else np.zeros((0, 2))
    assert 0 < y.shape[0] < 5000 and y.shape[1] == 2
    with IAudioFile(path) as f:
        np.testing.assert_array_equal(y, f.read_interleaved()[:y.shape[0]])


def test_file_loader_backpressure(tmp_path, rng, native_loader):
    """A byte ring much smaller than the file forces loader backpressure;
    the stream still arrives intact and in order."""
    payload = rng.integers(0, 256, size=200_000, dtype=np.uint8).tobytes()
    path = str(tmp_path / "blob.bin")
    with open(path, "wb") as f:
        f.write(b"HDR!" + payload)
    ring = native_rt.ByteRing(1 << 12)
    loader = native_rt.FileLoader(path, 4, len(payload), ring, chunk_bytes=1 << 10)
    got, n = [], 0
    deadline = time.time() + 30
    while n < len(payload) and time.time() < deadline:
        c = ring.read(3000)
        if c:
            got.append(c)
            n += len(c)
        else:
            time.sleep(0.0002)
    stats = loader.join()
    assert b"".join(got) == payload
    assert stats["bytes_read"] == len(payload) and stats["io_errors"] == 0
    with pytest.raises(OSError):
        native_rt.FileLoader(str(tmp_path / "missing.bin"), 0, 10, ring)


@pytest.mark.parametrize("native", [False, True])
def test_wav_stream_convolution(tmp_path, rng, native, request):
    """AudioBlockReader -> the port's carried-state process_any (blocks of
    8192 frames, then the tail's zeros) matches the whole-signal FastFIR and
    a float64 convolution of the same file data."""
    if native:
        request.getfixturevalue("native_loader")
    x = 0.1 * rng.standard_normal((2, 20000))
    ir = (0.05 * rng.standard_normal((2, 1200)) * np.exp(-np.arange(1200) / 300.0))
    pin = _write(tmp_path, "in.wav", x)
    with IAudioFile(pin) as f:
        x32 = f.read_interleaved().T.astype(np.float32)
    ir32 = ir.astype(np.float32)
    scheme = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    mir = mono.prepare_ir(scheme, ir32, offline_tail=False, device=CPU)
    state = mono.init_stream_state(scheme, mir, (2,))
    outs = []
    with AudioBlockReader(pin, 8192, native=native) as r:
        blocks = list(r) + [np.zeros((1199, 2), np.float32)]
    for blk in blocks:
        state, y = mono.process_any(mir, state, torch.from_numpy(np.ascontiguousarray(blk.T)))
        outs.append(y.numpy())
    y = np.concatenate(outs, axis=-1)
    assert y.shape == (2, 20000 + 1200 - 1)
    xpad = np.concatenate([x32, np.zeros((2, 1199), np.float32)], axis=-1)
    fast = FastFIR(ir32, device=CPU)(torch.from_numpy(xpad)).numpy()
    for c in range(2):
        ref = np.convolve(x32[c].astype(np.float64), ir32[c].astype(np.float64))
        assert snr_db(ref, y[c]) > 90
        assert snr_db(fast[c], y[c]) > 90


# -- native codec ----------------------------------------------------------------------

def test_codec_version_and_build_dir(lib):
    assert lib.ht_codec_version() == 1
    assert _native.library_path("hisstools_codec.cpp").parent == _native.BUILD_DIR


@pytest.mark.parametrize("fmt", list(PCMFormat))
@pytest.mark.parametrize("little", [True, False])
def test_native_matches_numpy(lib, rng, fmt, little, monkeypatch):
    x = np.clip(rng.standard_normal(1000) * 0.4, -0.999, 0.999)
    endian = Endianness.Little if little else Endianness.Big
    monkeypatch.setattr(af, "USE_NATIVE_CODEC", False)
    raw_np = af._encode_pcm(x, fmt, endian)
    assert native_codec.encode_pcm(x, fmt.value, little) == raw_np, f"{fmt} encode"
    dec_np = af._decode_pcm(raw_np, fmt, endian)
    assert np.array_equal(dec_np, native_codec.decode_pcm(raw_np, fmt.value, little))


def test_native_wave_uint8(lib, rng):
    x = np.clip(rng.standard_normal(500) * 0.5, -0.999, 0.992)
    raw = native_codec.encode_pcm(x, PCMFormat.Int8.value, True, wave_uint8=True)
    dec = native_codec.decode_pcm(raw, PCMFormat.Int8.value, True, wave_uint8=True)
    assert np.abs(dec - x).max() <= 2 ** -7 * 1.01
    b = np.frombuffer(raw, np.uint8)  # bytes really are offset-unsigned
    assert (b > 128).any() and (b < 128).any()


def test_file_roundtrip_through_native(lib, tmp_path, rng):
    path = str(tmp_path / "t.wav")
    x = np.clip(rng.standard_normal((128, 2)) * 0.4, -0.99, 0.99)
    with OAudioFile(path, FileType.WAVE, PCMFormat.Int24, 2, 48000.0) as o:
        o.write_interleaved(x)
    with IAudioFile(path) as i:
        assert np.abs(i.read_interleaved() - x).max() <= 2 ** -23 * 1.01
