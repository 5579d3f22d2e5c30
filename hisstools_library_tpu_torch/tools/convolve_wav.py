"""Convolve an audio file with an impulse response on the CUDA card.

Twin of the JAX repository's ``tools/convolve_wav.py``, with the same flags:
audio-file I/O (``io.audio_file``) -> convolution engine (``models``) ->
audio-file output. Runs on the card unless ``--cpu`` is given.

    python -m hisstools_library_tpu_torch.tools.convolve_wav input.wav ir.wav output.wav
    python -m hisstools_library_tpu_torch.tools.convolve_wav in.wav ir.wav out.wav --wet 0.4 --engine scheme

Engines: ``fast`` is ``FastFIR`` (K1 for the IR spectra, K5 per pass on the
card); ``scheme`` is ``mono.process_offline`` of the zero-latency scheme;
``--stream`` reads blocks with ``io.AudioBlockReader`` and runs
``mono.process`` on the zero-latency scheme with carried state.

Channels: a mono IR applies to every input channel; a multichannel IR applies
channel-per-channel (counts must then match). The tail (len(ir)-1 samples) is
rendered unless --trim. Output is peak-normalised only if it would clip
(--normalize forces it). The times of reading, convolving and writing go to
standard error.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _pcm_format(name: str):
    """--pcm choice -> PCMFormat (one mapping for both output paths)."""
    from ..io import PCMFormat
    return {"int16": PCMFormat.Int16, "int24": PCMFormat.Int24,
            "float32": PCMFormat.Float32}[name]


def read_wav(path):
    from ..io import IAudioFile, get_error_string

    with IAudioFile(path) as f:
        if f.get_is_error():
            msgs = "; ".join(get_error_string(e) for e in f.get_errors())
            raise SystemExit(f"{path}: {msgs}")
        data = f.read_interleaved()            # (frames, channels) float
        return np.asarray(data, np.float32).T, f.sampling_rate


def write_wav(path, x, sr, pcm="float32"):
    from ..io import FileType, OAudioFile

    fmt = _pcm_format(pcm)
    with OAudioFile(path, FileType.WAVE, fmt, x.shape[0], float(sr)) as f:
        f.write_interleaved(np.asarray(x, np.float64).T)


def _device(args) -> torch.device:
    from ..core.types import default_device
    return torch.device("cpu") if args.cpu else default_device()


def stream_convolve(args):
    """Constant-memory streaming path: AudioBlockReader (native prefetch
    loader + native codec when available) -> carried-state zero-latency
    scheme engine -> incremental OAudioFile writes. Memory use is bounded by
    the block size regardless of file length."""
    from ..io import FileType, OAudioFile
    from ..io.streaming import AudioBlockReader
    from ..models import mono
    from ..models.mono import LatencyMode, PartitionScheme

    dev = _device(args)
    ir, ir_sr = read_wav(args.ir)
    scheme = PartitionScheme.from_latency(LatencyMode.Zero)  # zero delay
    hop = scheme.sizes[-1] >> 1
    block = -(-args.block // hop) * hop

    reader = AudioBlockReader(args.input, block, dtype=np.float32)
    sr, cx = reader.sampling_rate, reader.channels
    if abs(sr - ir_sr) > 1e-6:
        print(f"warning: sample-rate mismatch ({sr} vs {ir_sr}); "
              "convolving anyway", file=sys.stderr)
    if ir.shape[0] == 1 and cx > 1:
        ir = np.repeat(ir, cx, axis=0)
    elif ir.shape[0] != cx and ir.shape[0] > 1:
        raise SystemExit(f"channel mismatch: input {cx}, IR {ir.shape[0]}")

    prep = mono.prepare_ir(scheme, ir, dtype=torch.float32, offline_tail=False,
                           device=dev)
    state = mono.init_state(scheme, prep, batch_shape=(cx,))

    fmt = _pcm_format(args.pcm)
    total_in = reader.frames
    tail = 0 if args.trim else ir.shape[1] - 1
    out_len = total_in + tail
    t0 = time.time()
    written = 0
    peak = 0.0
    with OAudioFile(args.output, FileType.WAVE, fmt, cx, float(sr)) as out:
        def emit(y, limit):
            nonlocal written, peak
            take = min(limit, out_len - written)
            if take <= 0:
                return
            yb = y[:, :take].cpu().numpy()
            peak = max(peak, float(np.abs(yb).max()))
            out.write_interleaved(yb.astype(np.float64).T)
            written += take

        for xb in reader:
            xb = xb.T  # (channels, frames)
            if xb.shape[-1] % hop:
                xb = np.pad(xb, ((0, 0), (0, hop - xb.shape[-1] % hop)))
            state, y = mono.process(prep, state,
                                    torch.from_numpy(np.ascontiguousarray(xb)).to(dev),
                                    backend="pallas")
            # Zero latency: engine output position == file position, so the
            # hop-padding samples carry real tail output: emit them all
            # (emit caps at out_len).
            emit(y, y.shape[-1])
        zeros = torch.zeros((cx, block), dtype=torch.float32, device=dev)
        while written < out_len:
            state, y = mono.process(prep, state, zeros, backend="pallas")
            emit(y, block)
    reader.close()
    dt = time.time() - t0
    rate = cx * out_len / max(dt, 1e-9) / (cx * sr)
    print(f"streamed {cx} ch x {out_len} frames in {dt:.2f}s "
          f"({rate:.0f}x real-time incl. IO; block {block}, peak {peak:.3f}"
          f"{', CLIPPED' if peak > 1.0 and args.pcm != 'float32' else ''})",
          file=sys.stderr)
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("ir")
    ap.add_argument("output")
    ap.add_argument("--engine", choices=("fast", "scheme"), default="fast",
                    help="fast = fused uniform-partition offline engine; "
                         "scheme = zero-latency non-uniform scheme (reference "
                         "kLatencyZero semantics)")
    ap.add_argument("--wet", type=float, default=1.0,
                    help="wet/dry mix: 1.0 = fully convolved")
    ap.add_argument("--trim", action="store_true",
                    help="cut the output at the input length (no reverb tail)")
    ap.add_argument("--normalize", action="store_true",
                    help="always peak-normalise to -1 dBFS")
    ap.add_argument("--pcm", choices=("int16", "int24", "float32"),
                    default="float32")
    ap.add_argument("--stream", action="store_true",
                    help="constant-memory streaming: read/convolve/write in "
                         "blocks (native prefetching loader when available); "
                         "input files of any length. --wet/--normalize are "
                         "whole-signal options and unavailable here")
    ap.add_argument("--block", type=int, default=1 << 16,
                    help="streaming block size in frames (rounded up to the "
                         "engine hop)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    if args.stream:
        if args.wet != 1.0 or args.normalize:
            raise SystemExit("--stream does not support --wet/--normalize "
                             "(whole-signal operations)")
        return stream_convolve(args)

    dev = _device(args)
    t0 = time.time()
    x, sr = read_wav(args.input)
    ir, ir_sr = read_wav(args.ir)
    print(f"read {args.input} and {args.ir} in {(time.time() - t0) * 1e3:.1f} ms",
          file=sys.stderr)
    if abs(sr - ir_sr) > 1e-6:
        print(f"warning: sample-rate mismatch ({sr} vs {ir_sr}); "
              "convolving anyway", file=sys.stderr)

    cx, L = x.shape
    cir = ir.shape[0]
    if cir == 1 and cx > 1:
        ir = np.repeat(ir, cx, axis=0)
    elif cir != cx and cir > 1:
        raise SystemExit(f"channel mismatch: input {cx}, IR {cir}")

    out_len = L if args.trim else L + ir.shape[1] - 1
    pad = out_len - L
    xs = np.pad(x, ((0, 0), (0, pad))).astype(np.float32)

    t0 = time.time()
    if args.engine == "fast":
        from ..models.offline import fast_fir
        y = fast_fir(torch.from_numpy(xs).to(dev), ir, backend="pallas")
    else:
        from ..models import mono
        from ..models.mono import LatencyMode, PartitionScheme
        scheme = PartitionScheme.from_latency(LatencyMode.Zero)
        hop = scheme.sizes[-1] >> 1
        if xs.shape[-1] % hop:
            xs = np.pad(xs, ((0, 0), (0, hop - xs.shape[-1] % hop)))
        prep = mono.prepare_ir(scheme, ir, dtype=torch.float32, device=dev)
        y = mono.process_offline(prep, torch.from_numpy(xs).to(dev), backend="pallas")
    y = y[:, :out_len].cpu().numpy()
    dt = time.time() - t0
    rate = cx * out_len / max(dt, 1e-9) / (cx * sr)
    print(f"convolved {cx} ch x {out_len} frames in {dt:.2f}s "
          f"({rate:.0f}x real-time incl. transfers)", file=sys.stderr)

    if args.wet != 1.0:
        dry = np.pad(x, ((0, 0), (0, pad)))
        y = args.wet * y + (1.0 - args.wet) * dry

    peak = float(np.abs(y).max()) or 1.0
    if args.normalize or peak > 1.0:
        y = y * (10 ** (-1 / 20) / peak)
        print(f"normalised (peak was {peak:.3f})", file=sys.stderr)

    t0 = time.time()
    write_wav(args.output, y, sr, args.pcm)
    print(f"wrote {args.output} in {(time.time() - t0) * 1e3:.1f} ms", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
