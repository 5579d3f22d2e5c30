"""Port parity: the command-line tools (``hisstools_library_tpu_torch/tools``).

The twins of ``tests/test_tools.py``'s CLI tests, each run with ``--cpu``
(the tools run on the card by default): the port's ``convolve_wav`` writes a
WAV that must hold the JAX test's bar against float64 ``np.convolve`` (> 90
dB) and >= 110 dB against the WAV the JAX package's ``tools/convolve_wav.py``
writes from the same input files (float32 sums in another order), for the
fast and scheme engines and ``--stream``. ``serve_demo`` (a Python
callback; the native host's real-time cadence is held on the card, in
``chip_smoke.py``) and ``fuzz_oracle`` must return 0.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from hisstools_library_tpu_torch.io import (FileType, IAudioFile, OAudioFile,  # noqa: E402
                                            PCMFormat)
from hisstools_library_tpu_torch.tools import (convolve_wav, fuzz_oracle,  # noqa: E402
                                               serve_demo)

SNR_JAX_CLI_DB = 110.0


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def _write(path, x, sr):
    """x: (frames,) or (channels, frames) float64, written as float32 WAV."""
    x = np.atleast_2d(x)
    with OAudioFile(path, FileType.WAVE, PCMFormat.Float32, x.shape[0], sr) as f:
        f.write_interleaved(x.T)


def _read(path):
    with IAudioFile(path) as f:
        return np.asarray(f.read_interleaved(), np.float64).T


def _both(tmp_path, x, ir, sr, flags):
    """Run the port's CLI and the JAX package's on the same files; returns
    (port output, JAX output), each (channels, frames)."""
    import convolve_wav as jax_cli

    sig_p, ir_p = str(tmp_path / "sig.wav"), str(tmp_path / "ir.wav")
    _write(sig_p, x, sr)
    _write(ir_p, ir, sr)
    out_port, out_jax = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    assert convolve_wav.main([sig_p, ir_p, out_port, "--cpu", *flags]) == 0
    jax_cli.main([sig_p, ir_p, out_jax, *flags])
    return _read(out_port), _read(out_jax)


def _normalised(ref):
    if np.abs(ref).max() > 1.0:
        ref = ref * (10 ** (-1 / 20) / np.abs(ref).max())
    return ref


@pytest.mark.parametrize("flags", [[], ["--stream"]], ids=["fast", "stream"])
def test_convolve_wav_cli(tmp_path, rng, flags):
    sr = 48000.0
    x = (0.3 * rng.standard_normal(20000)).astype(np.float64)
    ir = (rng.standard_normal(3000) * np.exp(-np.arange(3000) / 1000) * 0.1)
    y, y_jax = _both(tmp_path, x, ir, sr, flags)
    ref = np.convolve(x, ir)
    assert y.shape == (1, len(ref)) and y_jax.shape == y.shape
    if not flags:  # the whole-signal path normalises; --stream writes as is
        ref = _normalised(ref)
    assert snr_db(ref, y[0]) > 90.0
    assert snr_db(y_jax, y) >= SNR_JAX_CLI_DB


def test_convolve_wav_cli_scheme_engine(tmp_path, rng):
    sr = 44100.0
    x = (0.2 * rng.standard_normal((2, 9000))).astype(np.float64)
    ir = (rng.standard_normal(2000) * 0.05)
    y, y_jax = _both(tmp_path, x, ir, sr, ["--engine", "scheme", "--trim"])
    assert y.shape == (2, 9000) and y_jax.shape == y.shape
    ref = _normalised(np.stack([np.convolve(x[i], ir)[:9000] for i in range(2)]))
    assert snr_db(ref, y) > 90.0
    assert snr_db(y_jax, y) >= SNR_JAX_CLI_DB


def test_convolve_wav_cli_wet_and_channel_mismatch(tmp_path, rng):
    sr = 48000.0
    x = (0.2 * rng.standard_normal((2, 4000))).astype(np.float64)
    ir = rng.standard_normal((2, 500)) * 0.05
    y, y_jax = _both(tmp_path, x, ir, sr, ["--wet", "0.4", "--pcm", "int24"])
    wet = np.stack([np.convolve(x[i], ir[i]) for i in range(2)])
    ref = 0.4 * wet + 0.6 * np.pad(x, ((0, 0), (0, 499)))
    assert snr_db(ref, y) > 90.0
    assert snr_db(y_jax, y) >= SNR_JAX_CLI_DB
    _write(str(tmp_path / "ir3.wav"), np.zeros((3, 10)), sr)
    with pytest.raises(SystemExit, match="channel mismatch"):
        convolve_wav.main([str(tmp_path / "sig.wav"), str(tmp_path / "ir3.wav"),
                           str(tmp_path / "o.wav"), "--cpu"])
    with pytest.raises(SystemExit, match="does not support"):
        convolve_wav.main([str(tmp_path / "sig.wav"), str(tmp_path / "ir.wav"),
                           str(tmp_path / "o.wav"), "--cpu", "--stream", "--normalize"])


def test_serve_demo_returns_zero(capsys):
    assert serve_demo.main(["--cpu", "--seconds", "0.5", "--swaps", "1"]) == 0
    out = capsys.readouterr().out
    assert "swapped to IR 1" in out and out.rstrip().endswith("OK")


def test_fuzz_oracle_returns_zero(capsys):
    assert fuzz_oracle.main(["--cpu", "--minutes", "0.1", "--seed", "0"]) == 0
    out = capsys.readouterr().out
    assert "0 failures" in out and "fuzz: all cases passed" in out


@pytest.mark.parametrize("process", ["process", "process_any"])
def test_fuzz_streaming_draw_with_an_empty_first_call(rng, process):
    """The fuzz oracle's streaming draw splits a signal of one block into
    calls of 0 and 1 blocks: an empty call must give an empty output and
    leave the stream where it was, as in the JAX package (the port's head
    once raised in conv1d there)."""
    import jax.numpy as jnp

    from hisstools_library_tpu.models import mono as jmono
    from hisstools_library_tpu_torch.models import mono

    ir = (rng.standard_normal((2, 3000)) * 0.3).astype(np.float32)
    x = rng.standard_normal((2, 512)).astype(np.float32)
    init = "init_state" if process == "process" else "init_stream_state"
    jscheme = jmono.PartitionScheme((256, 1024), zero_latency=True)
    jprep = jmono.prepare_ir(jscheme, ir, offline_tail=False)
    jst = getattr(jmono, init)(jscheme, jprep, batch_shape=(2,))
    scheme = mono.PartitionScheme((256, 1024), zero_latency=True)
    prep = mono.prepare_ir(scheme, ir, offline_tail=False, device="cpu")
    st = getattr(mono, init)(scheme, prep, batch_shape=(2,))
    ys = []
    for xb in (x[:, :0], x):
        jst, jy = getattr(jmono, process)(jprep, jst, jnp.asarray(xb))
        st, y = getattr(mono, process)(prep, st, torch.from_numpy(xb))
        assert y.shape == jy.shape
        ys.append(y.numpy())
    ref = np.stack([np.convolve(x[i].astype(np.float64), ir[i].astype(np.float64))[:512]
                    for i in range(2)])
    assert snr_db(ref, ys[1]) > 120.0
    assert snr_db(jy, ys[1]) >= SNR_JAX_CLI_DB


def test_tools_take_the_jax_flags():
    """Every flag of the JAX tools is a flag of the twins, but the device
    flag: the fuzz oracle's --tpu is --cpu here (the card is the default)."""
    import ast
    from pathlib import Path

    def flags(path):
        return {n.args[0].value for n in ast.walk(ast.parse(Path(path).read_text()))
                if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument"
                and isinstance(n.args[0], ast.Constant)}

    root = Path(__file__).resolve().parent.parent
    for mod in (convolve_wav, serve_demo, fuzz_oracle):
        name = mod.__name__.rsplit(".", 1)[-1]
        want = flags(root / "tools" / f"{name}.py") - {"--tpu"}
        assert want <= flags(mod.__file__), name
        assert "--cpu" in flags(mod.__file__)
