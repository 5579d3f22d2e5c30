"""GPU smoke run of the PyTorch / Hopper port (hisstools_library_tpu_torch).

    python3 chip_smoke.py [--profile]

Needs one CUDA card (Hopper, sm_90a) and nvcc; imports nothing of JAX. It

1. prints the device, the torch and CUDA versions and the card's name and
   power limit as nvidia-smi reports them;
2. builds the kernels from ``hisstools_library_tpu_torch/csrc`` and prints the
   seconds it took;
3. compares each kernel of the FastFIR path (K1-K4, K5 fastfir_chain) with
   its plain PyTorch version on the card, at the main path's shapes and at
   N = 4096; K1 also at (128, N) for every N = 4096..2^17, each with its
   device and event ms, bound, ``torch.fft.rfft`` ms and the frames its
   one-pass route holds on the card at once; K4 also at its paths' shapes
   (128, 4, 2^15), (128, 16, 2^13) and (128, 236, 2^11), each with its device
   and event ms, bound and ``torch.fft.irfft`` ms; K2 (on K1's one-pass
   route, frames read in place) also at its only path shape,
   process_offline's 4096 section (128, 236 hops of 2^11), with its device
   and event ms, bound, ``torch.stft`` ms and the frames its route holds on
   the card at once, and at (3, 5 hops) of every N = 8192..2^17; K5 also at
   (2, 5, P 7, 2^14),
   (2, 3, P 2, 2^17), T = 1 and a P beyond shared memory, with the staged
   K2 -> K3 -> K4 timed beside it on the main path's inputs;
4. drives the main path: ``FastFIR`` at 128 channels x 480 000 taps (a 10 s
   IR at 48 kHz, N = 2^16) built from seed 0 as ``bench.py`` builds it, then
   three ``apply`` calls on the 128 x 483 328 signal (K1 and K5 must launch,
   none of K2, K3, K4); channel 0's first 65 536 samples must hold >= 99 dB
   SNR against a float64 ``np.convolve``; the pass's peak memory is printed
   beside a pass with the staged chain in K5's place;
5. times ten further passes with CUDA events (steady state);
6. compares each kernel of the hop-aligned streaming path (K7 lag_mac_ring,
   also at K = 64 and 16 bins, the ring MAC's narrow tiles; K8
   fastfir_chain_stream, K10 rfft_small) with its plain version; K8 also at
   (128, T 2, P 8, 2^17), (128, T 4, P 8, 2^16), the collapsed 16384
   sections of the benchmark's render (128, T 8, P 58, 2^14) and matrix
   (625, T 8, P 17, 2^14) cells with lag0, and a small lag-0 case at 2^16;
   at each of those path shapes (and the near tier with and without lag0)
   K8's three launches (forward, state kernel, inverse) by
   ``torch.profiler`` beside its design bytes and its bound, and the staged
   path ``process_block`` keeps where K8 does not serve (frames, K1 -> K7
   (+ the lag-0 product) -> K4) on the same inputs; K8's state kernel alone
   against its plain version at (128, T 2, P 8, 2^17);
   6b. K8's matrix form at the matrix cell's 25 x 25 (T 8, P 17, 2^14,
   lag0) and two small shapes against its plain version, its three launches
   beside its state kernel's design bytes, and K8 at render's shape in the
   same call;
7. drives ``mono.process`` as ``bench.py``'s ``stream`` mode configures it
   (Zero preset, ``prepare_ir(offline_tail=False)`` of the same IRs, calls of
   131 072 samples) through the two-tier, collapsed and matched paths;
8. checks the time-domain head's grouped conv1d on the card in full FP32;
9. compares each kernel of the sample-granular and staged offline paths (K6
   rifft_packed, K9 hop_fire, K11 rifft_small, K15 lag_mac) with its plain
   version, at those paths' shapes and at small shapes (K9 also timed at
   (128, 256, P 64) and (128, 1024, P 256), and at ragged channel counts
   and (128, 128, P 15);
   K15 also at 40 hops,
   three chunks of the ring MAC, with lead_skip 1); then K4 at its path
   shapes and the main path's (128, 16, 2^15) and K6 at (128, 2^14) and
   (128, 4096) must launch once a call and raise the peak allocation above
   their inputs by no more than their output (no scratch frame);
10. drives ``mono.process_any`` as ``bench.py``'s ``latency`` mode configures
    it: Zero preset, ``prepare_ir(offline_tail=False)``, ``init_stream_state``
    and 128 sequential 256-sample callbacks (K9, K6, K1 and K10 must launch);
    channel 0's whole output must hold >= 99 dB against a float64 FFT
    convolution; then times 128 further callbacks: ms per callback (CUDA
    events over the chain over the calls), host ms per call, the real-time
    factor (256 / 48 000 s over ms per callback) and peak memory;
11. hands a hop-aligned stream over to ``process_any``: one two-tier
    ``mono.process`` call of 131 072 samples then ``stream_state_from_block``,
    and one collapsed call then ``stream_state_from_aligned``, each followed by
    128 callbacks of 256 samples (K11 and K6 must launch); the joined output
    must hold >= 99 dB;
11a. serves the same stream through ``utils.serving.StreamingServer`` (128
    channels, Zero preset, the native swap cell: ``native=True`` fails if the
    runtime does not build): ``set_ir`` of the 10 s IRs (capacity grows to
    2^19), 128 x 32 768 samples of the signal written to a float32 WAV by
    ``io.OAudioFile`` and read back by ``io.AudioBlockReader`` through the
    native loader and codec in 256-sample blocks, 128 callbacks (K1, K6, K9
    and K10 must launch; channel 0 >= 99 dB against float64; the output equal,
    bit for bit, to ``mono.process_any`` on the capacity-padded IR); a
    callback while the cell is held must be silent; then a loader thread sets
    a second bank from the same generator while the audio thread keeps
    making complete callbacks (host block in, output on the host): every
    silent callback must be zeros, and from the state's reset point channel 0
    must hold >= 99 dB against the new IR's float64 convolution. Prints
    ``set_ir`` ms, ms per callback by events and by host clock, the
    callbacks' ms before, during and after the loader's preparation (the
    worst while it prepares) and the swap cell's class;
11b. checkpoints that stream: 64 callbacks of ``process_any`` at the serving
    shape, the state and the ``MonoIR`` through ``utils.checkpoint.save`` /
    ``restore`` (then ``save_npz`` / ``restore_npz``) into fresh exemplars on
    the card, 64 more; the output must equal the uninterrupted stream bit for
    bit;
11c. runs the per-stage SNR reports on the card (``utils.debug_stages``):
    ``stage_report`` at 4 channels, a 2^15-tap IR and 2^17 samples,
    ``stream_stage_report`` and ``two_tier_stage_report`` at the JAX tests'
    schemes and inputs, ``pipeline_stage_report`` at its test's inputs; each
    printed with the kernels it launched and held to the JAX tests' bars
    (95 / 200 for the doling / 90 / 80 and 50 for the deconvolution);
12. runs ``mono.process_offline`` on the 128 x 483 328 signal as ``bench.py``'s
    ``scheme`` mode does, with the offline tail (K5; none of K2, K3, K4) and
    without it (direct sections through K11 and conv1d, the 4096 section
    through K2 -> K3 -> K4 and the 16384 section through K5), >= 99 dB each,
    and times each;
13. runs the staged offline path: ``FastFIR`` of the first 48 000 taps at
    N = 2048 (outside the fused chain) on one second of signal, K10 -> K7 ->
    K11 (each must launch, K15 must not), >= 99 dB;
14. compares the spectral layer's kernels (K12 fft_split, K13
    rfft_packed_split, K14 rifft_packed_split) with their plain versions:
    K12 forward and inverse at (128, 2^17) and at (3, 1024), (2, 2^14), (1,
    2^17), (2, 2^18), (3, 2^19); K13 and K14 at (128, 2^20), (1, 2^19), (2,
    2^18), (1, 2^18), (5, 2^18); at the path shapes it prints each pass's
    device ms (``torch.profiler``) and the TB/s it reaches;
15. drives the spectral layer at 128 channels with the same IRs and 10 s
    signals: (a) ``spectral_processor.convolve`` (Linear, N = 2^20; K13, K14),
    (b) ``correlate`` (Wrap) and ``convolve`` (Fold) with the IRs' first
    48 000 taps (N = 2^20), (c) ``convolve_complex`` / ``correlate_complex``
    of 65 536-sample complex signals (N = 2^17; K12 three times a call), (d)
    ``change_phase`` of the IRs at phase 0 and 0.25 (N = 2^19; K13, K14
    twice each), (e) ``pipeline.ir_deconvolve`` of a 12 s capture of a 10 s
    log sweep through the IRs (N = 2^20), (f) ``convolve`` of 1 s signals
    with 1 s IRs (N = 2^17; K1, K6). Each holds channel 0 >= 99 dB against
    a float64 numpy mirror (d: against the port's float64 CPU path; where the
    plain float32 CPU path itself is below 99 dB, as the interpolated phase
    is, the bar is that SNR less 3 dB), and prints ms per call (CUDA events,
    median of 5 after a warm-up) and peak memory;
16. compares the windowed small transforms (K10w rfft_small_windowed, K11w
    rifft_small_windowed) with their plain versions: K10w on the STFT's
    frames as the strided ``unfold`` view of the 128 x 10 s padded signal
    (938 frames of 1024, hop 512) and of the pipeline's 2^18-sample IR, on
    (3, 256), with hop 341 (also from a base one float into the signal) and
    at N = 32 and 2048; K11w at (3, 256), (2, 9, 1024) and the path shapes;
17. runs the STFT round trip as ``bench.py``'s ``stft`` mode configures it:
    128 channels x 479 744 samples from seed 0, ``windows.hann(1023)``, N =
    1024, hop 512, ``boundary=True`` (K10w and K11w must launch); channel 0
    must hold >= 99 dB against the input; prints ms per pass (CUDA events,
    median of 5 after a warm-up), samples/s, the real-time factor, peak
    memory, and ``torch.stft`` + ``torch.istft`` beside it;
18. runs the IR pipeline as ``bench.py``'s ``pipeline`` mode configures it: a
    2^17-sample log sweep, a 4096-tap decaying IR from seed 0 and the full
    ``np.convolve`` capture, reg 1e-9, 16 peaks, smoothing widths (1, 63),
    STFT 1024 / 512. ``run_ir_pipeline_frames`` (K13, K14 and K10w must
    launch): the IR against a float64 numpy mirror of ``ir_deconvolve`` (>=
    99 dB, or the port's plain float32 CPU path's own SNR less 3 dB where
    that is below 99), the smoothed spectra and the peaks of the frames
    inside the IR against the port's float64 CPU run (>= 99 dB), the track
    states of those frames equal to that run's, and the share of all (frame,
    track) states equal to it (beyond the IR the deconvolved IR is rounding
    noise, whose peaks no two runs order alike); ms per pass, ms per tracker
    frame (CUDA graph replays, and the eager loop beside it) and samples/s.
    Then ``run_ir_pipeline`` on the same capture (K13 and K14), with the
    same checks on the IR, spectrum and peaks; then the frame chain on a
    20 Hz - 20 kHz exponential sweep through the same IR, its IR and
    smoothed spectra held to the plain float32 CPU path's own SNR less 3 dB
    (its empty top band amplifies float32 rounding on any device), the track
    states inside the IR equal to the float64 run's;
19. drives the multichannel ``Convolver`` with the same IRs and signal: (a)
    parallel 128 x 10 s IRs, ``process_offline`` (K5, none of K2-K4); (b)
    N2M 8 in x 8 out, the first 64 IRs as (8, 8, 480 000), ``process_offline``
    on 8 x 483 328 samples (K5 over the 64 pairs, then the sum); (c)
    parallel 128, ``PartitionScheme.for_latency_budget(65536)`` (one N = 2^17
    section, P = 8), three ``process`` calls of 131 072 samples (K8); (d)
    N2M 8 x 8, Zero preset, IRs cut to 290 000 taps, ``init_block_state``,
    three calls of 131 072 samples (near tier K8 at 2^14, far tier K8 at
    2^16 with P2 = 8; no K7); (d2) the same 8 x 8 bank from ``init_state``,
    three calls of 131 072 samples through the matrix route (K8's matrix
    form, no per-pair K8); (e) N2M 2 x 2, 64 callbacks of 256 samples
    through ``process_any``. Output 0 of each holds >= 99 dB against a
    float64 FFT convolution (N2M: summed over the inputs); ms per call by
    CUDA events and peak memory;
20. compares the FFT sizes below 32 points (``csrc/fft_tiny.cu``: K10's and
    K11's tiny forms at real N = 2..16, their windowed forms, K12's at
    complex N = 1..16) with their plain versions, timed at (128, N) beside
    ``torch.fft`` and on the 16-point STFT's frames of 128 x 1 s;
21. drives the calls that pick those sizes: ``spectral_processor.convolve``
    and ``convolve_complex`` of 128 pairs of 5-sample signals (N = 16) and
    the STFT round trip with 16-point frames (hop 8) of 128 x 1 s, each
    against float64 (>= 99 dB);
22. compares the sizes above real 2^20 / complex 2^19 with their plain
    versions: K13 and K14 at every real N = 2^21..2^28, K12 forward and
    inverse at every complex N = 2^20..2^28, each at a batch that moves at
    least 1 GiB (one frame at the top sizes), >= 110 dB, with device and
    event ms, the bound, the ``torch.fft`` call's time and the call's peak
    memory;
23. drives the public calls there at full width: ``spectral_processor.
    convolve`` of 128 channels of 20 s signals with the 10 s IRs (N = 2^21)
    and ``pipeline.ir_deconvolve`` of a 30 s capture of a 25 s log sweep at
    96 kHz through the IRs (N = 2^22), each against a float64 numpy mirror
    of channel 0 (>= 99 dB), with ms per call and peak memory;
24. runs the six gradient cases of ``tests/test_torch_autograd.py`` (the
    tests' seed and shapes) on the card: each must either give the CPU
    run's gradient (>= 110 dB) or raise ``_build.NoBackwardError`` naming a
    hand kernel (the kernels have no backward); then ``mono.process`` at
    the stream shape (Zero preset, 128 channels, the 10 s IRs, one two-tier
    call of 131 072 samples) with an input that requires grad must raise it;
25. drives ``parallel`` at world size 1 over NCCL (a process group made and
    destroyed in the phase; collectives across cards are not exercised on
    a one-card host): (a) ``scheme_offline_sharded`` of the Zero scheme
    without the tail on the 128 x 483 328 signal, its 4096 and 16384
    sections as K2 -> K15 (lead_skip 1) -> K4 (each must launch, K5 must
    not), channel 0 >= 99 dB against float64 and >= 110 dB against
    ``process_offline``, with ms/pass, peak memory, K15's shapes there and
    K15 against its plain version at the largest; (b) ``n_to_one_offline``
    against (a)'s channel sum; (c) ``scheme_stream_sharded``, two two-tier
    calls bit-equal to ``mono.process``; (d) ``scheme_stream_any_sharded``,
    128 callbacks of 256 samples bit-equal to ``process_any``; (e) the
    sharded FFTs and ``convolve_sharded`` against their single-card
    counterparts (>= 110 dB) and the convolution against float64;
26. runs the double-float FFT (``fft.df64``) on the card: ``selfcheck()``
    (< 1e-10: the compensation survived), the round trip ``rifft_df64(
    rfft_df64(x)) == 2N x`` and ``fft_df64`` forward and inverse at 128 x
    2^16 against float64 numpy (>= 250 dB), with ms per call;
27. runs the ``convolve_wav`` tool (``tools/convolve_wav.main``) at full
    width: the 128 x 483 328 signal and the 10 s IRs written as float32
    WAVs to a temporary directory (removed at the phase's end), then
    ``--engine fast``, ``--engine scheme`` and ``--stream``, each with its
    read, convolve and write times; channel 0 of each output WAV >= 120 dB
    against a float64 FFT convolution, scaled as the tool scales its output
    (peak-normalised to -1 dBFS by the peak of the float64 convolution's
    channel that holds the output's peak; ``--stream`` writes unscaled);
28. runs the ``serve_demo`` tool with ``--channels 128 --seconds 2 --swaps
    2``, as a Python callback and with ``--native-host``: each must return
    0 (its own post-swap parity check, and the native host's overruns);
    its median / p99 callback ms and late callbacks are information;
29. runs the ``fuzz_oracle`` tool for 0.5 minutes from seed 0 on the card:
    it must return 0 (every draw above 85 dB against float64);
30. holds determinism on the card: every kernel of ``KERNELS`` launched
    twice on the same inputs at its first path shape, with a NaN-filled
    block (large and small pools) handed back by the caching allocator
    before the second launch, must give the same bits (an output element a
    kernel never writes would show) and leave its inputs as they were; the
    same for whole paths, each from a fresh state: one FastFIR pass, 128
    ``process_any`` callbacks and two two-tier ``mono.process`` calls; then
    the long stream: 64 two-tier calls of 131 072 samples at 128 channels
    with the 10 s IRs, channel 0's first and last calls >= 120 dB against
    a float64 FFT convolution and within 15 dB of each other.

Phase 14b, run after phase 14 (its kernels' path cases serve phase 30),
times K16 (``csrc/bin_product.cu``, the per-bin products of packed spectra)
alone at its two path shapes, the 20 s convolution's (128, 2^20)
(``bin_mul``, ``bin_mul_conj``; bound 0.96 ms) and the sweep
deconvolution's (128, 2^21) against one excitation row (``bin_deconvolve``
with its floor; bound 1.29 ms), and ``bin_floor`` at that row: a launch's
device ms in a CUDA graph, from which the rate and the share of the bound
its bytes reach come, beside the event ms, the profiler's device ms and the
plain version (``packed_mul`` for the products, the glue they replaced);
each kernel against its plain version at small shapes too (one float a
lane, K = 1, a broadcast first operand, a floor a row). The deconvolution's
old glue (unpack, division, pack, copy, scale) is timed by
``tools/chip_phases.py --k16`` on a parent checkout.
Phase 15's convolutions, correlation and deconvolution launch it.

Every path runs with every kernel's launch count set to 0 just before it and
read just after; a kernel the path needs that was not launched fails the run,
and so does any kernel below 110 dB against its plain version, any path below
99 dB against float64, and any non-finite output. Launches made to compare a
kernel with its plain version do not count. Each kernel's times are taken at
its first path shape: the median of 5 by CUDA events after a warm-up, around
the wrapper's call (so the wrapper's host time is in it), and the device time
of its launches by ``torch.profiler``; beside them its bound, the larger of
its bytes (each input read once, each output written once; overlapping
frames count the signal they cover once) over 3.35 TB/s and
its operations over 67 TFLOP/s (H100 SXM HBM and FP32 peaks), and the time of
one PyTorch call that computes the same function where there is one
(``torch.fft`` / ``torch.stft``; the port never calls it). ``--profile``
adds a ``torch.profiler`` window over the streaming paths, ``process_any``,
the STFT round trip and the two pipeline chains. The line before the last is a JSON object with each
kernel's launches by path, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SNR_MIN_KERNEL_DB = 110.0   # kernel vs plain version, f32 sums in another order
SNR_MIN_MATRIX_DB = 126.0   # K8's matrix form vs plain at the matrix cell (K8's own reads 127.6)
SNR_MIN_PATH_DB = 99.0      # main path vs float64 oracle
SNR_MIN_TD_DB = 120.0       # conv1d head vs float64 (TF32 would give ~60 dB)
CHANNELS, FS, IR_LEN, SIG_LEN = 128, 48000, 480000, 483328
STREAM_BLOCK = 131072       # bench.py's stream call: 16 hops of 8192
CALLBACK, CALLS = 256, 128  # bench.py's latency mode: 256-sample callbacks, 2 x 64
STAGED_TAPS, STAGED_N = 48000, 2048
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak rate
SNR_MIN_DF64_DB = 250.0     # double-float vs float64 (the JAX package's chip: 281-283)
SNR_MIN_CLI_DB = 120.0      # the tools' WAVs and the long stream vs float64
FP32_FLOPS = 67e12          # H100 SXM FP32 outside the tensor cores

# Every kernel of the port: (wrapper module, CUDA source, TPU kernel replaced).
KERNELS = {
    "rfft_packed": ("hopper_fft", "rfft_packed.cu", "fft/pallas_fft.py:461"),
    "rfft_packed_stream": ("hopper_fft", "rfft_packed_stream.cu", "fft/pallas_fft.py:1368"),
    "lag_mac_causal": ("hopper_kernels", "lag_mac_causal.cu", "fft/pallas_kernels.py:231"),
    "rifft_packed_tail": ("hopper_fft", "rifft_packed_tail.cu", "fft/pallas_fft.py:1440"),
    "rifft_packed": ("hopper_fft", "rifft_packed.cu", "fft/pallas_fft.py:518"),
    "lag_mac_ring": ("hopper_kernels", "ring_mac.cu", "fft/pallas_kernels.py:566"),
    "fastfir_chain": ("hopper_fft", "fastfir_chain.cu", "fft/pallas_fft.py:1685"),
    "fastfir_chain_stream": ("hopper_fft", "fastfir_stream.cu", "fft/pallas_fft.py:1943"),
    # K8's matrix form: the TPU package runs an N2M matrix's pairs through K8.
    "fastfir_chain_stream_matrix": ("hopper_fft", "fastfir_stream.cu",
                                    "fft/pallas_fft.py:1943"),
    "hop_fire": ("hopper_kernels", "hop_fire.cu", "fft/pallas_kernels.py:383"),
    "rfft_small": ("hopper_fft", "rfft_small.cu", "fft/pallas_fft.py:1079"),
    "rifft_small": ("hopper_fft", "rifft_small.cu", "fft/pallas_fft.py:1114"),
    "lag_mac": ("hopper_kernels", "ring_mac.cu", "fft/pallas_kernels.py:109"),
    "fft_split": ("hopper_fft", "fft_split.cu", "fft/pallas_fft.py:856"),
    "rfft_packed_split": ("hopper_fft", "rfft_packed_split.cu", "fft/pallas_fft.py:664"),
    "rifft_packed_split": ("hopper_fft", "rifft_packed_split.cu", "fft/pallas_fft.py:775"),
    "rfft_small_windowed": ("hopper_fft", "rfft_small.cu", "fft/pallas_fft.py:1238"),
    "rifft_small_windowed": ("hopper_fft", "rifft_small.cu", "fft/pallas_fft.py:1265"),
    # Below 32 points the TPU package leaves Pallas for its matmul_fft
    # fallback (pallas_fft.py:471 forward, :529 inverse, :868 complex).
    "rfft_tiny": ("hopper_fft", "fft_tiny.cu", "fft/pallas_fft.py:471"),
    "rifft_tiny": ("hopper_fft", "fft_tiny.cu", "fft/pallas_fft.py:529"),
    "rfft_tiny_windowed": ("hopper_fft", "fft_tiny.cu", "fft/pallas_fft.py:471"),
    "rifft_tiny_windowed": ("hopper_fft", "fft_tiny.cu", "fft/pallas_fft.py:529"),
    "fft_tiny": ("hopper_fft", "fft_tiny.cu", "fft/pallas_fft.py:868"),
    # K16 replaces no TPU kernel: the JAX package's jnp steps.
    "bin_mul": ("hopper_kernels", "bin_product.cu", "ops/spectral.py:208 (jnp)"),
    "bin_mul_conj": ("hopper_kernels", "bin_product.cu", "ops/spectral.py:220 (jnp)"),
    "bin_deconvolve": ("hopper_kernels", "bin_product.cu", "models/pipeline.py:51-58 (jnp)"),
    "bin_floor": ("hopper_kernels", "bin_product.cu", "models/pipeline.py:53-54 (jnp)"),
}
STAGED = ("rfft_packed_stream", "lag_mac_causal", "rifft_packed_tail")
# (T, K) at which K4's kernel runs at 128 channels: as K8's inverse at the
# two-tier far tier (N = 2^16) and the collapsed and matched final sections
# (2^14), and as K4 at the offline 4096 section without the tail.
K4_PATH_SHAPES = ((4, 1 << 15), (16, 1 << 13), (236, 1 << 11))
K2_PATH_SHAPE = (236, 1 << 11)  # (T, hop): process_offline's 4096 section, no tail


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def snr_db(ref: torch.Tensor, test: torch.Tensor) -> float:
    ref = ref.double()
    err = test.double() - ref
    den = float((err * err).sum())
    return float("inf") if den == 0 else 10 * np.log10(float((ref * ref).sum()) / den)


def median_ms(fn, runs: int = 5) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(call, reps: int = 20, runs: int = 5) -> float:
    """Device ms of one call: ``reps`` calls captured in a CUDA graph (after
    one warm-up call), the graph replayed ``runs`` times between CUDA events
    (median), so the host's launch time is not in it."""
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            call()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return sorted(times)[runs // 2]


SPAN_PREFIX = "hst::"  # the port's spans (utils/profiling.span)


def device_events(prof) -> list:
    """The profiler's averages of what ran on the card: its CUDA events less
    the port's spans, which the profiler gives the device time of the
    kernels they hold (so a sum over both counts each kernel twice), and
    less :func:`profiled`'s opening launches."""
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"
            and e.device_time_total > 0 and not e.key.startswith(SPAN_PREFIX)
            and OPENING_KERNEL not in e.key]


# torch.cuda._sleep's kernel, which no call of the port launches.
OPENING_KERNEL = "spin_kernel"


def profiled(fn, runs: int = 5, warm_up: bool = True) -> list:
    """:func:`device_events` of ``runs`` calls of ``fn`` under
    ``torch.profiler``, after a warm-up call unless ``warm_up`` is False.
    With the card's torch 2.11 a profiling session can lose the kernel
    records of its first launches, one or two calls' worth once this
    script's serving paths (phase 11) have run. So each session opens with
    a few launches of ``torch.cuda._sleep`` and a pause, and those launches
    are left out of the events."""
    from torch.profiler import ProfilerActivity, profile
    if warm_up:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.02)
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return device_events(prof)


def device_ms(fn, runs: int = 5) -> float:
    """Device time per call by ``torch.profiler`` (:func:`profiled`): the
    sum of the CUDA kernels one call launches, without the host time between
    them (which ``median_ms`` includes, as the events wait for the wrapper's
    enqueue)."""
    return sum(e.device_time_total for e in profiled(fn, runs)) / runs / 1e3


def convolve_f64(x: np.ndarray, h: np.ndarray, n: int) -> np.ndarray:
    """conv(x, h)[:n] in float64 through one FFT longer than the full result."""
    size = 1 << (len(x) + len(h) - 2).bit_length()
    spec = np.fft.rfft(x.astype(np.float64), size) * np.fft.rfft(h.astype(np.float64), size)
    return np.fft.irfft(spec, size)[:n]


def fft_flops(n: int, frames: int) -> float:
    """Operations of ``frames`` real transforms of size n: 2.5 N log2 N each
    (half a complex N-point FFT's 5 N log2 N)."""
    return 2.5 * n * math.log2(n) * frames


def kernel_flops(name, args, kwargs) -> float:
    """Operations the kernel's function does on these inputs (for a MAC, the
    valid lags only: 8 real operations per complex multiply-add)."""
    a = args[0]
    if name in ("rfft_packed", "rfft_small", "rfft_packed_split", "rfft_tiny"):
        return fft_flops(a.shape[-1], a.numel() // a.shape[-1])
    if name in ("rfft_small_windowed", "rfft_tiny_windowed"):  # and one multiply a sample
        return fft_flops(a.shape[-1], a.numel() // a.shape[-1]) + a.numel()
    if name in ("rifft_small_windowed", "rifft_tiny_windowed"):  # two multiplies a sample
        return fft_flops(2 * a.shape[-1], a.numel() // a.shape[-1]) + 4.0 * a.numel()
    if name in ("fft_split", "fft_tiny"):  # a complex N-point FFT: 5 N log2 N
        return 2 * fft_flops(a.shape[-1], a.numel() // a.shape[-1])
    if name in ("rifft_packed", "rifft_small", "rifft_packed_tail", "rifft_packed_split",
                "rifft_tiny"):
        return fft_flops(2 * a.shape[-1], a.numel() // a.shape[-1])
    if name == "rfft_packed_stream":
        return fft_flops(2 * a.shape[-1], a.numel() // a.shape[-1])
    if name in ("bin_mul", "bin_mul_conj", "bin_deconvolve"):
        # a complex product and its scale; the division's power, floor,
        # quarter scales and two quotients
        return (14.0 if name == "bin_deconvolve" else 8.0) * max(a.numel(), args[2].numel())
    if name == "bin_floor":
        return 3.0 * a.numel()
    if name == "lag_mac_causal":
        c, t, k = a.shape
        p = args[2].shape[-2]
        return 8.0 * c * k * sum(min(p, i) for i in range(t))
    if name == "lag_mac_ring":
        c, p, k = a.shape
        return 8.0 * c * args[2].shape[1] * p * k
    if name == "lag_mac":
        c, _, k = a.shape
        return 8.0 * c * args[4] * args[2].shape[-2] * k
    if name == "hop_fire":
        c, n = a.shape
        p = args[1].shape[-2]
        return c * (2 * fft_flops(n, 1) + 8.0 * p * (n // 2))
    if name == "fastfir_chain":  # two transforms per hop and the causal MAC
        c, t, h = a.shape
        p = args[1].shape[-2]
        return (c * t * 2 * fft_flops(2 * h, 1)
                + 8.0 * c * h * sum(min(p, i) for i in range(t)))
    if name == "fastfir_chain_stream_matrix":  # each input's and output's transforms once
        ins, t, h = a.shape
        outs, _, p = args[4].shape[:3]
        return ((ins + outs) * t * fft_flops(2 * h, 1)
                + 8.0 * outs * ins * t * (p + ("l0_re" in kwargs)) * h)
    # fastfir_chain_stream: two transforms and the P-lag MAC per hop (+ lag 0)
    c, t, h = a.shape
    p = args[2].shape[1]
    return c * t * (2 * fft_flops(2 * h, 1) + 8.0 * (p + ("l0_re" in kwargs)) * h)


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a function must move for ``t``: each element once, and for a
    view whose elements share memory (the STFT's ``unfold`` frames, which
    overlap) the storage span it covers, each stored value once."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))
    return min(t.numel(), span) * t.element_size()


def bound(name, args, kwargs, got) -> tuple:
    """The least time the card could take: (ms, "bytes" or "operations")."""
    tensors = [a for a in list(args) + list(kwargs.values()) if isinstance(a, torch.Tensor)]
    nbytes = sum(tensor_bytes(t) for t in tensors + list(got))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = kernel_flops(name, args, kwargs) / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _complex_of_packed(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """The N/2 + 1-bin complex spectrum the packed planes stand for."""
    zero = torch.zeros_like(re[..., :1])
    return torch.complex(torch.cat([re, im[..., :1]], -1),
                         torch.cat([zero, im[..., 1:], zero], -1))


def library_call(name, args, kwargs):
    """One PyTorch call computing the kernel's function on the same inputs
    (in torch's own layout, converted before the timing), or None."""
    a = args[0]
    if name in ("rfft_packed", "rfft_small", "rfft_packed_split", "rfft_tiny"):
        return lambda: torch.fft.rfft(a, dim=-1)
    if name in ("rfft_small_windowed", "rfft_tiny_windowed"):
        if a.dim() != 3:
            return None
        # The (C, T, N) unfold view's signal, stored where the view reads it.
        c, t, n = a.shape
        hop = a.stride(1)
        sig = a.as_strided((c, (t - 1) * hop + n), (a.stride(0), 1))
        w = args[1]
        return lambda: torch.stft(sig, n, hop_length=hop, window=w, center=False,
                                  return_complex=True)
    if name in ("fft_split", "fft_tiny"):
        z = torch.complex(args[0], args[1])
        f = torch.fft.ifft if kwargs.get("inverse") else torch.fft.fft
        return lambda: f(z, dim=-1)
    if name in ("rifft_packed", "rifft_small", "rifft_packed_tail", "rifft_packed_split",
                "rifft_tiny"):
        z = _complex_of_packed(args[0], args[1])
        n = 2 * a.shape[-1]
        return lambda: torch.fft.irfft(z, n=n, dim=-1)
    if name == "rfft_packed_stream":
        c, t, h = a.shape
        sig = torch.nn.functional.pad(a.reshape(c, t * h), (h, 0))
        win = torch.ones(2 * h, device=a.device)
        return lambda: torch.stft(sig, 2 * h, hop_length=h, window=win, center=False,
                                  return_complex=True)
    return None


def compare(name, fn, plain, args, kwargs, big, smi):
    """Kernel vs plain version on the same inputs: SNR, max abs error and, at
    a path shape, both times, the library call's time and the bound. Fails
    below SNR_MIN_KERNEL_DB or on non-finite output."""
    got = fn(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    snr = min(snr_db(w, g) for w, g in zip(want, got))
    err = max(float((g - w).abs().max()) for w, g in zip(want, got))
    shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
    opts = {k: tuple(v.shape) if isinstance(v, torch.Tensor) else v
            for k, v in sorted(kwargs.items())}
    print(f"{name} {shapes}{' ' + str(opts) if kwargs else ''}: SNR vs plain "
          f"{snr:.2f} dB, max abs err {err:.3e}", flush=True)
    if not (snr >= SNR_MIN_KERNEL_DB and all(bool(torch.isfinite(g).all()) for g in got)):
        fail(f"{name} at {shapes}: SNR {snr:.2f} dB < {SNR_MIN_KERNEL_DB}")
    out = dict(shapes=shapes, snr_db=snr, max_abs_err=err)
    if big:
        out["ms"] = median_ms(lambda: fn(*args, **kwargs))
        out["device_ms"] = device_ms(lambda: fn(*args, **kwargs))
        out["plain_ms"] = median_ms(lambda: plain(*args, **kwargs))
        lib = library_call(name, args, kwargs)
        out["library_ms"] = None if lib is None else median_ms(lib)
        out["bound_ms"], out["bound_by"] = bound(name, args, kwargs, got)
        lib_txt = "" if lib is None else f", library {out['library_ms']:.4f} ms"
        print(f"  time at path shape: kernel {out['ms']:.4f} ms (device "
              f"{out['device_ms']:.4f} ms by the profiler), plain "
              f"{out['plain_ms']:.4f} ms{lib_txt}, bound {out['bound_ms']:.4f} ms "
              f"({out['bound_by']}) [{smi}]", flush=True)
    return out


def check_kernels(specs, mods, smi) -> dict:
    """Each kernel against its plain version over its cases; the first path
    shape (``big``) gives the kernel's times and bound, and its input maker
    (``path_case``) phase 30's inputs."""
    results = {}
    for name, cases in specs:
        mod = mods[KERNELS[name][0]]
        entries = []
        for make, big in cases:
            args, kwargs = make()
            entries.append(compare(name, getattr(mod, name), getattr(mod, name + "_plain"),
                                   args, kwargs, big, smi))
            del args, kwargs
            torch.cuda.empty_cache()
        main = next(e for e in entries if "ms" in e)
        _, src, rep = KERNELS[name]
        results[name] = dict(
            name=name, route="cuda", source=f"hisstools_library_tpu_torch/csrc/{src}",
            replaces=f"hisstools_library_tpu/{rep}",
            max_abs_err=max(e["max_abs_err"] for e in entries),
            snr_db=min(e["snr_db"] for e in entries),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by")},
            shapes=entries,
            # The first path shape's input maker, for phase 30 (taken out
            # before the kernels' line is printed).
            path_case=next(make for make, big in cases if big))
    return results


def time_calls(step, runs: int = 10):
    """Median and all of ``runs`` calls of ``step`` (CUDA events), after one
    warm-up call."""
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), times


def profile_calls(step, label: str, ms_per_call: float, smi: str, calls: int = 5) -> None:
    """Device time by kernel over ``calls`` calls, and the busy share: device
    time per call over the unprofiled call time ``ms_per_call``."""
    rows = [(e.key, e.device_time_total, e.count)
            for e in profiled(step, calls, warm_up=False)]
    busy_ms = sum(r[1] for r in rows) / calls / 1e3
    print(f"profile {label}: device busy {busy_ms:.4f} ms/call over {calls} calls; "
          f"busy share {busy_ms / ms_per_call:.3f} of the {ms_per_call:.4f} ms/call "
          f"steady state [{smi}]", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {us / calls / 1e3:9.4f} ms/call  x{count // calls:<3d} {key[:90]}",
              flush=True)


class Launches:
    """Every kernel wrapper's launch count, set to 0 before a path and read
    after it."""

    def __init__(self, mods):
        self.fns = {name: getattr(mods[mod], name) for name, (mod, _, _) in KERNELS.items()}
        self.by_path = {}

    def reset(self) -> None:
        for fn in self.fns.values():
            fn.launches = 0

    def read(self, path: str, need, smi: str, forbid=()) -> dict:
        counts = {k: fn.launches for k, fn in self.fns.items()}
        self.by_path[path] = counts
        print(f"{path}: launches {({k: v for k, v in counts.items() if v})} [{smi}]",
              flush=True)
        for k in need:
            if counts[k] < 1:
                fail(f"{path}: kernel {k} was not launched")
        for k in forbid:
            if counts[k]:
                fail(f"{path}: kernel {k} was launched {counts[k]} times; this path "
                     "does not run it")
        return counts


def phase_ms(fn, smi: str, label: str, runs: int = 5) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches (its phases),
    by ``torch.profiler`` (:func:`profiled`)."""
    out = {e.key[:60]: e.device_time_total / runs / 1e3 for e in profiled(fn, runs)}
    print(f"{label} phases (device ms per call): "
          f"{ {k: round(v, 4) for k, v in out.items()} } [{smi}]", flush=True)
    return out


def fastfir_kernels(randn, mods, smi) -> dict:
    """Phase 3: K1-K5 at the main path's shapes and at N = 4096; K1 also at
    128 frames of every N = 4096..2^17, with its one-pass route's frames
    resident at once beside each shape's times. Main path:
    N = 2^16, hop H = 32 768, C = 128 channels, T = ceil((SIG_LEN + H) / H)
    = 16 hops, P = ceil(IR_LEN / H) = 15 partitions, min(P, T - 1) = 15 lags.
    The small shape (N = 4096) has more partitions than hops. K5 also at
    (2, 5, P 7, 2^14), (2, 3, P 2, 2^17), (2, T 2, P 1, 2^16), T = 1 (whose
    output is exactly zero) and P = 60 at 2^16 (beyond
    the 47 lags its blocks hold in shared memory there); the staged
    K2 -> K3 -> K4 is timed beside it on the main path's inputs, with the
    design's own bound (its scratch frames included) beside the function's."""
    n_main = 1 << 16
    hop = n_main // 2
    t_main = -(-(SIG_LEN + hop) // hop)
    p_main = -(-IR_LEN // hop)

    def inputs(name, n, big):
        c, t, lags = ((CHANNELS, t_main, min(p_main, t_main - 1)) if big else (2, 5, 7))
        k = n // 2

        def make():
            if name == "rfft_packed":
                return (randn(c * p_main if big else 3, n),), {}
            if name == "rfft_packed_stream":
                return (randn(c, t, k),), {}
            if name == "lag_mac_causal":
                return (randn(c, t, k), randn(c, t, k), randn(c, lags, k),
                        randn(c, lags, k)), {}
            return (randn(c, t, k), randn(c, t, k), 1.0 / (4.0 * n)), {}
        return make, big

    def chain(c, t, p, n):
        k = n // 2
        return lambda: ((randn(c, t, k), randn(c, p, k) * 1e-3, randn(c, p, k) * 1e-3,
                         1.0 / (4.0 * n)), {})

    def k1(b, n):
        return lambda: ((randn(b, n),), {})

    def k4(c, t, k):
        return lambda: ((randn(c, t, k), randn(c, t, k), 1.0 / (8.0 * k)), {})

    def k2(c, t, k):
        return lambda: ((randn(c, t, k),), {})

    lags = min(p_main, t_main - 1)
    results = check_kernels(
        [("rfft_packed", [inputs("rfft_packed", 4096, False),
                          inputs("rfft_packed", n_main, True)]
          + [(k1(CHANNELS, 1 << e), True) for e in range(12, 18)])]
        + [("rfft_packed_stream", [inputs("rfft_packed_stream", 4096, False),
                                   inputs("rfft_packed_stream", n_main, True),
                                   (k2(CHANNELS, *K2_PATH_SHAPE), True)]
            + [(k2(3, 5, 1 << e), False) for e in range(12, 17)])]
        + [("lag_mac_causal", [inputs("lag_mac_causal", 4096, False),
                               inputs("lag_mac_causal", n_main, True)])]
        + [("rifft_packed_tail", [inputs("rifft_packed_tail", 4096, False),
                                  inputs("rifft_packed_tail", n_main, True)]
            + [(k4(CHANNELS, t, k), True) for t, k in K4_PATH_SHAPES])]
        + [("fastfir_chain", [(chain(CHANNELS, t_main, lags, n_main), True),
                              (chain(2, 5, 7, 1 << 14), False),
                              (chain(2, 3, 2, 1 << 17), False),
                              (chain(2, 2, 1, n_main), False),
                              (chain(2, 3, 60, n_main), False)])], mods, smi)
    hf = mods["hopper_fft"]
    for e in results["rfft_packed"]["shapes"]:
        if "ms" not in e:
            continue
        n = e["shapes"][0][-1]
        e["resident"] = hf.rfft_packed_resident(n)
        print(f"K1 one pass at {e['shapes'][0]}: device {e['device_ms']:.4f} ms, events "
              f"{e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
              f"torch.fft.rfft {e['library_ms']:.4f} ms, SNR vs plain {e['snr_db']:.2f} dB, "
              f"{e['resident']} frames resident at once ({hf._onepass_plan(n).blocks} "
              f"blocks a frame) [{smi}]", flush=True)
    for e in results["rfft_packed_stream"]["shapes"][2:3]:
        n = 2 * e["shapes"][0][-1]
        e["resident"] = hf.rfft_packed_stream_resident(n)
        print(f"K2 at its path shape {e['shapes'][0]}: device {e['device_ms']:.4f} ms, "
              f"events {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
              f"torch.stft {e['library_ms']:.4f} ms, SNR vs plain {e['snr_db']:.2f} dB, "
              f"{e['resident']} frames resident at once [{smi}]", flush=True)
    for e in results["rifft_packed_tail"]["shapes"]:
        if "ms" in e:
            print(f"K4 one pass at {e['shapes'][0]}: device {e['device_ms']:.4f} ms, events "
                  f"{e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
                  f"torch.fft.irfft {e['library_ms']:.4f} ms, SNR vs plain "
                  f"{e['snr_db']:.2f} dB [{smi}]", flush=True)
    # T = 1: x[-1] = 0 and K5 has no lag-0 term, so the one hop's output is
    # exactly zero (held as such, not as an SNR).
    args, _ = chain(2, 1, 3, n_main)()
    y1 = hf.fastfir_chain(*args)
    torch.cuda.synchronize()
    if tuple(y1.shape) != tuple(args[0].shape) or bool(y1.abs().max() != 0):
        fail(f"fastfir_chain at T = 1: shape {tuple(y1.shape)}, max |y| "
             f"{float(y1.abs().max()):.3e}, not the exact zero output")
    print("fastfir_chain at (2, T 1, P 3, 2^16): the output is exactly zero", flush=True)
    args, _ = chain(CHANNELS, t_main, lags, n_main)()
    staged = median_ms(lambda: hf.fastfir_chain_staged(*args))
    x2d = args[0]
    scratch = 4 * 2 * x2d.numel() * 4  # the frames: written by A, read and written by B, read by C
    design = (2 * tensor_bytes(x2d) + sum(tensor_bytes(a) for a in args[1:3])
              + tensor_bytes(x2d) + scratch) / HBM_BYTES_PER_S * 1e3
    r = results["fastfir_chain"]
    r["staged_ms"], r["design_bound_ms"] = staged, design
    r["phase_ms"] = phase_ms(lambda: hf.fastfir_chain(*args), smi, "fastfir_chain")
    print(f"fastfir_chain at the main path's inputs: K5 {r['ms']:.4f} ms, staged "
          f"K2 -> K3 -> K4 {staged:.4f} ms (CUDA events, median of 5); bound "
          f"{r['bound_ms']:.4f} ms (x, y, H), the design's own {design:.4f} ms (its "
          f"scratch frames and the signal read twice) [{smi}]", flush=True)
    del args, x2d
    torch.cuda.empty_cache()
    return results


def k8_launches(fn, smi: str, label: str, runs: int = 5) -> dict:
    """Device ms per call of K8's three launches (csrc/fastfir_stream.cu):
    the forward (``fft_onepass`` with the in-place stream loader), the state
    kernel (the ring MAC, ``ring_mac`` in csrc/ring_mac.cu) and the inverse
    (``fft_onepass`` with the tail store), by ``torch.profiler``
    (:func:`profiled`)."""
    out = {"forward": 0.0, "state": 0.0, "inverse": 0.0, "other": 0.0}
    for e in profiled(fn, runs):
        ms = e.device_time_total / runs / 1e3
        key = ("state" if "ring_mac" in e.key else
               "forward" if "fft_onepass" in e.key and ", 4, 0>" in e.key else
               "inverse" if "fft_onepass" in e.key and ", 2, 1>" in e.key else "other")
        out[key] += ms
    print(f"{label}: K8 launches (device ms per call) "
          f"{ {k: round(v, 4) for k, v in out.items()} } [{smi}]", flush=True)
    return out


def stream_kernels(randn, mods, smi) -> dict:
    """Phase 6: K7, K8 and K10 at the hop-aligned paths' shapes. K7 at two
    wide shapes, (128, T 4, P 14, K 32768) and (128, T 16, P 58, K 8192),
    which every path now sends to K8 and which stand for the staged route's
    state step at many lags, at the staged FastFIR's (128, T 48, P 47,
    K 1024) (phase 13's path, a zero ring), and on the ring MAC's narrow
    tiles (K = 64 and K = 16: a block of one warp a channel). K8 at the near tier (T = 16, H =
    8192, P = 3) with and without lag0, a small 2^15 case, a single 2^17
    section over a 10 s IR (T = 2, P = 8), the far tier of a 290 000-tap IR
    (2^16, T = 4, P = 8), the collapsed 16384 sections of the benchmark's
    render (128 channels, T = 8, P = 58) and matrix (625 pairs, T = 8,
    P = 17) cells with lag0, and a small lag-0 case at 2^16; at each path
    shape K8 is compared with its plain version and timed beside its bound,
    with its three launches, its design bytes and the staged path (frames,
    K1 -> K7 (+ the lag-0 product) -> K4) on the same inputs; and K8's state
    kernel against its plain version at the 2^17 section's shape. K10 at the
    IR preparation and refresh sizes (384 rows)."""
    def ring(c, t, p, k):
        return lambda: (tuple(randn(c, r, k) for r in (p, p, t, t, p, p)), {})

    def chain(c, t, p, n, lag0):
        def make():
            k = n // 2
            kw = dict(l0_re=randn(c, k) * 1e-3, l0_im=randn(c, k) * 1e-3) if lag0 else {}
            return (randn(c, t, k), randn(c, k), randn(c, p, k), randn(c, p, k),
                    randn(c, p, k) * 1e-3, randn(c, p, k) * 1e-3, 1.0 / (4.0 * n)), kw
        return make

    def small(b, n):
        return lambda: ((randn(b, n),), {})

    t_staged = -(-(STAGED_TAPS + STAGED_N // 2) // (STAGED_N // 2))
    p_staged = -(-STAGED_TAPS // (STAGED_N // 2))
    # (C, T, P, N, lag0) of K8's path shapes; the last two are the
    # collapsed 16384 sections of the render and matrix cells.
    wide = ((CHANNELS, 16, 3, 1 << 14, True), (CHANNELS, 16, 3, 1 << 14, False),
            (CHANNELS, 2, 8, 1 << 17, False), (CHANNELS, 4, 8, 1 << 16, False),
            (CHANNELS, 8, 58, 1 << 14, True), (625, 8, 17, 1 << 14, True))
    results = check_kernels([
        ("lag_mac_ring", [(ring(2, 3, 5, 1024), False), (ring(CHANNELS, 4, 14, 32768), True),
                          (ring(CHANNELS, 16, 58, 8192), True),
                          (ring(CHANNELS, t_staged, p_staged, STAGED_N // 2), True),
                          (ring(CHANNELS, 4, 14, 64), False), (ring(19, 3, 5, 16), False)]),
        ("fastfir_chain_stream", [(chain(2, 3, 2, 1 << 14, True), False),
                                  (chain(2, 11, 8, 1 << 15, True), False)]
         + [(chain(*w), True) for w in wide]
         + [(chain(2, 3, 4, 1 << 16, True), False)]),
        ("rfft_small", [(small(7, 32), False), (small(384, 256), True), (small(384, 128), True),
                        (small(384, 1024), True), (small(384, 2048), True)]),
    ], mods, smi)
    hf, hk = mods["hopper_fft"], mods["hopper_kernels"]
    from hisstools_library_tpu_torch.core.types import Split, packed_mul

    def staged(x2d, prev, rr, ri, hr, hi, scale, l0_re=None, l0_im=None):
        # process_block's staged path on the same inputs: the frames
        # [prev | cur] materialised, K1, K7, the lag-0 product, K4.
        frames = torch.cat([torch.cat([prev[:, None], x2d[:, :-1]], 1), x2d], -1)
        xre, xim = hf.rfft_packed(frames)
        yre, yim, _, _ = hk.lag_mac_ring(rr, ri, xre, xim, hr, hi)
        if l0_re is not None:
            prod = packed_mul(Split(xre, xim), Split(l0_re[:, None], l0_im[:, None]))
            yre, yim = yre + prod.re, yim + prod.im
        return hf.rifft_packed_tail(yre, yim, scale)

    per_shape = {}
    for c, t, p, n, lag0 in wide:
        label = f"({c}, T {t}, P {p}, {n}{', lag0' if lag0 else ''})"
        args, kw = chain(c, t, p, n, lag0)()
        got = hf.fastfir_chain_stream(*args, **kw)
        b_ms, b_by = bound("fastfir_chain_stream", args, kw, got)
        design = hf._stream_design_bytes(c, t, p, n, lag0)
        split = k8_launches(lambda: hf.fastfir_chain_stream(*args, **kw), smi,
                            f"fastfir_chain_stream {label}")
        entry = dict(launches_ms=split, device_ms=sum(split.values()),
                     ms=median_ms(lambda: hf.fastfir_chain_stream(*args, **kw)),
                     staged_ms=median_ms(lambda: staged(*args, **kw)),
                     staged_device_ms=device_ms(lambda: staged(*args, **kw)),
                     design_bytes=design, design_ms=design / HBM_BYTES_PER_S * 1e3,
                     bound_ms=b_ms, bound_by=b_by)
        per_shape[label] = entry
        print(f"fastfir_chain_stream {label}: device {entry['device_ms']:.4f} ms, events "
              f"{entry['ms']:.4f} ms; design bytes {design / 1e9:.4f} GB "
              f"({entry['design_ms']:.4f} ms at 3.35 TB/s), bound {b_ms:.4f} ms ({b_by}); "
              f"staged path (frames, K1 -> K7 -> K4) device {entry['staged_device_ms']:.4f} ms, "
              f"events {entry['staged_ms']:.4f} ms [{smi}]", flush=True)
        del args, kw, got
        torch.cuda.empty_cache()
    results["fastfir_chain_stream"]["per_shape"] = per_shape

    # K8's state kernel alone at the 2^17 section's shape: X of 2 hops, the
    # ring and H of 8 lags.
    c, t, p, k = CHANNELS, 2, 8, 1 << 16
    args = (randn(c, t, k), randn(c, t, k), randn(c, p, k), randn(c, p, k),
            randn(c, p, k) * 1e-3, randn(c, p, k) * 1e-3)
    got = hf.stream_state(*args)
    want = hf.stream_state_plain(*args)
    torch.cuda.synchronize()
    snr = min(snr_db(w, g) for w, g in zip(want, got))
    err = max(float((g - w).abs().max()) for w, g in zip(want, got))
    nbytes = sum(tensor_bytes(a) for a in list(args) + list(got))
    state = dict(snr_db=snr, max_abs_err=err, device_ms=device_ms(lambda: hf.stream_state(*args)),
                 ms=median_ms(lambda: hf.stream_state(*args)),
                 plain_ms=median_ms(lambda: hf.stream_state_plain(*args)),
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    print(f"stream_state (K8's state kernel) ({c}, T {t}, P {p}, K {k}): SNR vs plain "
          f"{snr:.2f} dB, max abs err {err:.3e}; device {state['device_ms']:.4f} ms, events "
          f"{state['ms']:.4f} ms, plain {state['plain_ms']:.4f} ms, bound "
          f"{state['bound_ms']:.4f} ms (bytes) [{smi}]", flush=True)
    if not (snr >= SNR_MIN_KERNEL_DB and all(bool(torch.isfinite(g).all()) for g in got)):
        fail(f"stream_state at ({c}, {t}, {p}, {k}): SNR {snr:.2f} dB < {SNR_MIN_KERNEL_DB}")
    results["fastfir_chain_stream"]["state_kernel"] = state
    del args, got, want
    torch.cuda.empty_cache()
    return results


def stream_matrix_kernel(randn, mods, smi) -> dict:
    """Phase 6b: K8's matrix form (``fastfir_chain_stream_matrix``) against
    its plain version at the benchmark's matrix cell, 25 inputs x 25
    outputs, T 8, P 17, N = 2^14 with lag0 (SNR >= SNR_MIN_MATRIX_DB), and
    at (2 in, 3 out, T 3, P 2, 2^14) and (3 in, 2 out, T 2, P 20, 2^16,
    no lag0): its three launches' device ms beside its state kernel's design
    bytes (H and L0 once, each input's ring in and out once, X and Y once)
    and the function's bound, event ms and the plain version's ms; then K8
    at render's (128, T 8, P 58, 2^14, lag0) in the same call, which the
    matrix form leaves as it was."""
    hf = mods["hopper_fft"]

    def matrix(ins, outs, t, p, n, lag0):
        def make():
            k = n // 2
            kw = (dict(l0_re=randn(outs, ins, k) * 1e-3, l0_im=randn(outs, ins, k) * 1e-3)
                  if lag0 else {})
            return (randn(ins, t, k), randn(ins, k), randn(ins, p, k), randn(ins, p, k),
                    randn(outs, ins, p, k) * 1e-3, randn(outs, ins, p, k) * 1e-3,
                    1.0 / (4.0 * n)), kw
        return make

    cell = (25, 25, 8, 17, 1 << 14, True)
    results = check_kernels([("fastfir_chain_stream_matrix", [
        (matrix(2, 3, 3, 2, 1 << 14, True), False), (matrix(*cell), True),
        (matrix(3, 2, 2, 20, 1 << 16, False), False)])], mods, smi)
    r = results["fastfir_chain_stream_matrix"]
    cell_snr = r["shapes"][1]["snr_db"]
    if cell_snr < SNR_MIN_MATRIX_DB:
        fail(f"fastfir_chain_stream_matrix at the matrix cell: SNR {cell_snr:.2f} dB < "
             f"{SNR_MIN_MATRIX_DB}")
    ins, outs, t, p, n, _ = cell
    k = n // 2
    # The state kernel's bytes: H and L0 of the pairs, the inputs' rings in
    # and out, X and Y.
    design = 8 * k * (outs * ins * (p + 1) + 2 * ins * p + ins * t + outs * t)
    args, kw = matrix(*cell)()
    r["launches_ms"] = k8_launches(lambda: hf.fastfir_chain_stream_matrix(*args, **kw), smi,
                                   "fastfir_chain_stream_matrix (25 x 25, T 8, P 17, 16384, "
                                   "lag0)")
    r["state_design_ms"] = design / HBM_BYTES_PER_S * 1e3
    print(f"fastfir_chain_stream_matrix (25 x 25, T 8, P 17, 16384, lag0): device "
          f"{r['device_ms']:.4f} ms, events {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; "
          f"state kernel {r['launches_ms']['state']:.4f} ms against its design bytes "
          f"{design / 1e9:.4f} GB ({r['state_design_ms']:.4f} ms at 3.35 TB/s); the function's "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); SNR vs plain {cell_snr:.2f} dB "
          f"[{smi}]", flush=True)
    del args, kw
    torch.cuda.empty_cache()
    c, t, p, n = CHANNELS, 8, 58, 1 << 14
    k = n // 2
    args = (randn(c, t, k), randn(c, k), randn(c, p, k), randn(c, p, k),
            randn(c, p, k) * 1e-3, randn(c, p, k) * 1e-3, 1.0 / (4.0 * n))
    kw = dict(l0_re=randn(c, k) * 1e-3, l0_im=randn(c, k) * 1e-3)
    split = k8_launches(lambda: hf.fastfir_chain_stream(*args, **kw), smi,
                        "fastfir_chain_stream render (128, T 8, P 58, 16384, lag0)")
    print(f"fastfir_chain_stream render (128, T 8, P 58, 16384, lag0): device "
          f"{sum(split.values()):.4f} ms, events "
          f"{median_ms(lambda: hf.fastfir_chain_stream(*args, **kw)):.4f} ms [{smi}]",
          flush=True)
    del args, kw
    torch.cuda.empty_cache()
    return results


def slice_kernels(randn, mods, smi) -> dict:
    """Phase 9: K6, K9, K11 and K15. Path shapes: K6 at 128 rows of N = 4096
    and 16384 (``_emit`` of the Zero preset's two large sections); K11 at
    (128, 256) and (128, 1024) (hand-offs, direct-section taps) and at the
    staged FastFIR's 128 x 48 frames of 2048; K9 at (C = 128, N = 256, P = 3)
    and (128, 1024, 3); K15 at (C = 128, T = 48, P = 47, K = 1024), the
    staged FastFIR's shape before that path took K7 (phase 6 checks K7
    there; ``parallel``'s K15 shapes are recorded in its own phase). Small and edge shapes: K6 at (3, 4096) and (2, 2^17), K11 at
    (7, 32), K9 at (3, 32, P = 1), (9, 64, P = 20), at ragged channel
    counts (127 at N = 256, 33 at N = 32; 1001 at N = 256, four frames a
    block and a ragged last block), at (128, 128, P = 15) (the N = 128
    section of a (128, 2048) scheme: a plan of the most shared memory), and
    timed also at
    (128, 256, P 64) and (128, 1024, P 256); K15 with lead_skip 1
    (also at T = 40 over P = 17: three chunks of 16 hops)."""
    def inverse(b, n):
        return lambda: ((randn(b, n // 2), randn(b, n // 2)), {})

    def fire(c, n, p):
        k = n // 2
        return lambda: ((randn(c, n), randn(c, p, k), randn(c, p, k), randn(c, p, k) * 1e-3,
                         randn(c, p, k) * 1e-3), {})

    def mac(c, skip, t, p, k):
        return lambda: ((randn(c, skip + t + p, k), randn(c, skip + t + p, k),
                         randn(c, p, k), randn(c, p, k), t), dict(lead_skip=skip))

    t_staged = -(-(STAGED_TAPS + STAGED_N // 2) // (STAGED_N // 2))
    p_staged = -(-STAGED_TAPS // (STAGED_N // 2))
    return check_kernels([
        ("rifft_packed", [(inverse(3, 4096), False), (inverse(2, 1 << 17), False),
                          (inverse(CHANNELS, 16384), True), (inverse(CHANNELS, 4096), True)]),
        ("hop_fire", [(fire(3, 32, 1), False), (fire(9, 64, 20), False),
                      (fire(CHANNELS, 256, 3), True), (fire(CHANNELS, 1024, 3), True),
                      (fire(CHANNELS, 256, 64), True), (fire(CHANNELS, 1024, 256), True),
                      (fire(CHANNELS - 1, 256, 3), False), (fire(33, 32, 3), False),
                      (fire(1001, 256, 3), False), (fire(CHANNELS, 128, 15), False)]),
        ("rifft_small", [(inverse(7, 32), False), (inverse(CHANNELS, 256), True),
                         (inverse(CHANNELS, 1024), True),
                         (inverse(CHANNELS * t_staged, STAGED_N), True)]),
        ("lag_mac", [(mac(2, 1, 5, 7, 256), False),
                     (mac(CHANNELS, 0, t_staged, p_staged, STAGED_N // 2), True),
                     (mac(CHANNELS, 1, 40, 17, 256), False)]),
    ], mods, smi)


def one_pass_inverses(randn, mods, smi) -> None:
    """Phase 9b: K4 and K6 at their path shapes launch once a call on the
    one-pass route and allocate nothing but their output (peak memory above
    the inputs)."""
    hf = mods["hopper_fft"]
    cases = ([("rifft_packed_tail", (CHANNELS, 16, 1 << 15))]  # the main path's 16 hops
             + [("rifft_packed_tail", (CHANNELS, t, k)) for t, k in K4_PATH_SHAPES]
             + [("rifft_packed", (CHANNELS, k)) for k in (1 << 13, 1 << 11)])
    for name, shape in cases:
        fn = getattr(hf, name)
        re, im = randn(*shape), randn(*shape)
        rest = (1.0 / (8.0 * shape[-1]),) if name == "rifft_packed_tail" else ()
        fn(re[:1], im[:1], *rest)  # the twiddle table, cached for the size
        torch.cuda.synchronize()
        before = fn.launches
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(re, im, *rest)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        print(f"{name} {shape}: {fn.launches - before} launch, peak {extra} bytes above "
              f"its inputs for a {out.numel() * 4}-byte output [{smi}]", flush=True)
        if fn.launches - before != 1 or extra > out.numel() * 4:
            fail(f"{name} at {shape}: {fn.launches - before} launches, {extra} bytes "
                 f"allocated for a {out.numel() * 4}-byte output (a scratch frame?)")
        del re, im, out
        torch.cuda.empty_cache()


def fastfir_path(dev, irs, x, launches, smi) -> None:
    """Phases 4 and 5: the FastFIR main path."""
    from hisstools_library_tpu_torch.models.offline import FastFIR

    xd = torch.from_numpy(x).to(dev)
    launches.reset()
    t0 = time.perf_counter()
    eng = FastFIR(irs, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    pass_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        y = FastFIR.apply(eng.spectra, xd)
        torch.cuda.synchronize()
        pass_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"main path: FastFIR N={eng.fft_size}, P={eng.spectra.shape[-2]}, "
          f"IR prep {prep_s:.3f} s, passes {[round(v, 3) for v in pass_ms]} ms [{smi}]",
          flush=True)
    launches.read("fastfir", ("rfft_packed", "fastfir_chain"), smi, forbid=STAGED)
    if tuple(y.shape) != (CHANNELS, SIG_LEN) or not bool(torch.isfinite(y).all()):
        fail(f"main path output: shape {tuple(y.shape)}, finite "
             f"{bool(torch.isfinite(y).all())}")
    check = 1 << 16
    ref = np.convolve(x[0, :check].astype(np.float64),
                      irs[0, :check].astype(np.float64))[:check]
    snr = snr_db(torch.from_numpy(ref), y[0, :check].cpu())
    ms = float(np.median(pass_ms))
    print(f"main path: SNR vs float64 np.convolve (ch0, {check} samples) "
          f"{snr:.2f} dB; {ms:.3f} ms/pass (median of 3), "
          f"{CHANNELS * SIG_LEN / (ms * 1e-3):.6e} samples/s [{smi}]", flush=True)
    if not snr >= SNR_MIN_PATH_DB:
        fail(f"main path SNR {snr:.2f} dB < {SNR_MIN_PATH_DB}")
    steady = median_ms(lambda: FastFIR.apply(eng.spectra, xd), runs=10)
    print(f"main path steady state: {steady:.4f} ms/pass (CUDA events, median "
          f"of 10 after a warm-up), {CHANNELS * SIG_LEN / (steady * 1e-3):.6e} "
          f"samples/s [{smi}]", flush=True)
    del y
    peak_pass(eng, xd, smi)
    del eng, xd
    torch.cuda.empty_cache()


def peak_pass(eng, xd, smi) -> None:
    """Peak device memory of one FastFIR pass above what was allocated before
    it (K5 through the entry point), and of the staged K2 -> K3 -> K4 called
    on the hop blocks and H views that pass hands K5."""
    from hisstools_library_tpu_torch.fft import hopper_fft
    from hisstools_library_tpu_torch.models.offline import FastFIR

    def peak(step) -> float:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = step()
        torch.cuda.synchronize()
        del y
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    peaks = {"K5": peak(lambda: FastFIR.apply(eng.spectra, xd))}
    # The pass's own inputs to the chain: x padded to whole hops with the
    # look-ahead hop (FastFIR's shift), H's first min(P, T - 1) partitions.
    h = eng.spectra.shape[-1]
    length = xd.shape[-1] + h
    t = -(-length // h)
    lags = min(eng.spectra.shape[-2], t - 1)
    c = xd.shape[0]

    def staged():
        x2d = torch.nn.functional.pad(xd, (0, t * h - xd.shape[-1])).reshape(c, t, h)
        hr = eng.spectra.re[..., :lags, :].expand(c, lags, h).contiguous()
        hi = eng.spectra.im[..., :lags, :].expand(c, lags, h).contiguous()
        return hopper_fft.fastfir_chain_staged(x2d, hr, hi, 1.0 / (4.0 * 2 * h))

    peaks["staged K2 -> K3 -> K4"] = peak(staged)
    print(f"main path peak memory per pass (above the IR and signal): K5 "
          f"{peaks['K5']:.3f} GiB, staged K2 -> K3 -> K4 "
          f"{peaks['staged K2 -> K3 -> K4']:.3f} GiB [{smi}]", flush=True)
    if peaks["staged K2 -> K3 -> K4"] - peaks["K5"] < 0.5 * 1e9 / 2**30:
        fail("main path: K5's pass is not 0.5 GB below the staged chain's peak")


def stream_paths(dev, irs, x, launches, smi, profile) -> None:
    """Phase 7: mono.process through the two-tier, collapsed and matched
    paths (two-tier: IR prep + 3 calls; K1, K8, K10 must launch; collapsed:
    2 calls; K1 (the 4096 section's refresh), K8, K10; matched: IR prep + 2
    calls; K1, K8; K8 serves every section of N = 2^14..2^17 at any P, so
    none launches K7 or K4), each >= 99 dB on channel 0's whole output, then
    timed over ten calls."""
    from hisstools_library_tpu_torch.models import mono

    blk = STREAM_BLOCK
    xd = torch.from_numpy(np.ascontiguousarray(x[:, :3 * blk])).to(dev)
    blocks = [xd[:, i * blk:(i + 1) * blk].contiguous() for i in range(3)]
    del xd
    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    matched = mono.PartitionScheme.for_latency_budget(8192)

    def run(label, scheme, ir, init, calls, need, forbid=("lag_mac_ring", "rifft_packed_tail")):
        launches.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if ir is None:
            ir = mono.prepare_ir(scheme, irs, offline_tail=False, device=dev)
            torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        state = init(scheme, ir, batch_shape=(CHANNELS,))
        ys, host_ms = [], []
        for i in range(calls):
            t0 = time.perf_counter()
            state, y = mono.process(ir, state, blocks[i])
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            if tuple(y.shape) != (CHANNELS, blk) or not bool(torch.isfinite(y).all()):
                fail(f"{label} call {i}: output shape {tuple(y.shape)}, finite "
                     f"{bool(torch.isfinite(y).all())}")
            ys.append(y[0].cpu().numpy())
            del y
        print(f"{label}: sections {[tuple(s.shape) for s in ir.spectra]}, far "
              f"{None if ir.far is None else tuple(ir.far.shape)}, IR prep {prep_s:.3f} s, "
              f"calls {[round(v, 3) for v in host_ms]} ms (host clock) [{smi}]", flush=True)
        launches.read(label, need, smi, forbid)
        n = calls * blk
        lat = scheme.latency
        ref = convolve_f64(x[0, :n], irs[0], n - lat)
        snr = snr_db(torch.from_numpy(ref), torch.from_numpy(np.concatenate(ys)[lat:]))
        if not snr >= SNR_MIN_PATH_DB:
            fail(f"{label}: SNR {snr:.2f} dB < {SNR_MIN_PATH_DB}")
        carry = {"s": state}

        def step():
            carry["s"], _ = mono.process(ir, carry["s"], blocks[0])

        ms, times = time_calls(step)
        print(f"{label}: SNR vs float64 FFT convolution (ch0, {n} samples) {snr:.2f} dB; "
              f"steady state {ms:.4f} ms/call (CUDA events, median of 10; all "
              f"{[round(v, 4) for v in times]}), {CHANNELS * blk / (ms * 1e-3):.6e} "
              f"samples/s, real-time factor {blk / FS / (ms * 1e-3):.2f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]", flush=True)
        if profile:
            profile_calls(step, label, ms, smi)
        del carry, state
        return ir

    k_all = ("rfft_packed", "fastfir_chain_stream")
    ir = run("two-tier", zero, None, mono.init_block_state, 3, k_all + ("rfft_small",))
    run("collapsed", zero, ir, mono.init_state, 2, k_all + ("rfft_small",))
    del ir
    torch.cuda.empty_cache()
    run("matched", matched, None, mono.init_state, 2, k_all)
    torch.cuda.empty_cache()


def time_domain_check(dev, smi) -> None:
    """Phase 8: the head's grouped conv1d in full FP32 on the card."""
    from hisstools_library_tpu_torch.models import time_domain

    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, STREAM_BLOCK)).astype(np.float32)
    h = rng.standard_normal((4, 128)).astype(np.float32)
    y = time_domain.fir_offline(torch.from_numpy(x).to(dev), torch.from_numpy(h).to(dev))
    snr = min(snr_db(torch.from_numpy(convolve_f64(x[c], h[c], x.shape[-1])), y[c].cpu())
              for c in range(4))
    print(f"time-domain head: conv1d (4 x {STREAM_BLOCK}, 128 taps) on the card, SNR vs "
          f"float64 {snr:.2f} dB (TF32 off) [{smi}]", flush=True)
    if not snr >= SNR_MIN_TD_DB:
        fail(f"time-domain head SNR {snr:.2f} dB < {SNR_MIN_TD_DB}: TF32 still on?")


def callbacks(ir, state, xd, start: int, calls: int):
    """``calls`` sequential process_any callbacks of CALLBACK samples from
    sample ``start`` of ``xd``; returns the state, channel 0's output (on the
    card) and the host ms of each call (the enqueue: no synchronisation)."""
    from hisstools_library_tpu_torch.models import mono

    blocks = [xd[:, start + i * CALLBACK:start + (i + 1) * CALLBACK].contiguous()
              for i in range(calls)]
    ys, host_ms = [], []
    for blk in blocks:
        t0 = time.perf_counter()
        state, y = mono.process_any(ir, state, blk)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ys.append(y[0])
    return state, torch.cat(ys), host_ms


def check_path_snr(label, y0: torch.Tensor, x0: np.ndarray, h: np.ndarray, smi) -> float:
    """Channel 0's whole output against a float64 FFT convolution."""
    y0 = y0.cpu()
    if not bool(torch.isfinite(y0).all()):
        fail(f"{label}: non-finite output")
    n = y0.shape[-1]
    snr = snr_db(torch.from_numpy(convolve_f64(x0[:n], h, n)), y0)
    print(f"{label}: SNR vs float64 FFT convolution (ch0, {n} samples) {snr:.2f} dB [{smi}]",
          flush=True)
    if not snr >= SNR_MIN_PATH_DB:
        fail(f"{label}: SNR {snr:.2f} dB < {SNR_MIN_PATH_DB}")
    return snr


def subhop_paths(dev, irs, x, launches, smi, profile) -> None:
    """Phases 10 and 11: process_any at 256-sample callbacks, and the
    hop-aligned -> sample-granular hand-offs."""
    from hisstools_library_tpu_torch.models import mono

    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    n_any = 2 * CALLS * CALLBACK
    xd = torch.from_numpy(np.ascontiguousarray(x[:, :STREAM_BLOCK + n_any])).to(dev)

    launches.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ir = mono.prepare_ir(zero, irs, offline_tail=False, device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    state = mono.init_stream_state(zero, ir, batch_shape=(CHANNELS,))
    state, y0, _ = callbacks(ir, state, xd, 0, CALLS)
    torch.cuda.synchronize()
    print(f"process_any: Zero preset {zero.sizes}, IR prep {prep_s:.3f} s, {CALLS} "
          f"callbacks of {CALLBACK} samples [{smi}]", flush=True)
    launches.read("process_any", ("hop_fire", "rifft_packed", "rfft_packed", "rfft_small"),
                  smi)
    check_path_snr("process_any", y0, x[0], irs[0], smi)

    # Steady state: the next CALLS callbacks as one chain, CUDA events around it.
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    state, y1, host_ms = callbacks(ir, state, xd, CALLS * CALLBACK, CALLS)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / CALLS
    check_path_snr("process_any (continued)", torch.cat([y0, y1]), x[0], irs[0], smi)
    print(f"process_any: {ms:.4f} ms/callback (CUDA events over {CALLS} sequential "
          f"callbacks / {CALLS}), host {float(np.mean(host_ms)):.4f} ms/call mean, "
          f"{float(np.median(host_ms)):.4f} median, {max(host_ms):.4f} max (enqueue, "
          f"no sync); real-time factor {CALLBACK / FS / (ms * 1e-3):.2f} for {CHANNELS} "
          f"channels; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{smi}]", flush=True)
    if profile:
        carry = {"s": state}

        def step():
            for i in range(32):
                carry["s"], _ = mono.process_any(
                    ir, carry["s"], xd[:, i * CALLBACK:(i + 1) * CALLBACK].contiguous())

        profile_calls(step, "process_any (32 callbacks per call)", ms * 32, smi, calls=2)
        del carry
    del state, y0, y1

    def handoff(label, init, lift):
        launches.reset()
        torch.cuda.reset_peak_memory_stats()
        st = init(zero, ir, batch_shape=(CHANNELS,))
        st, yb = mono.process(ir, st, xd[:, :STREAM_BLOCK].contiguous())
        ss = lift(ir, st)
        ss, ya, _ = callbacks(ir, ss, xd, STREAM_BLOCK, CALLS)
        torch.cuda.synchronize()
        launches.read(label, ("rifft_small", "rifft_packed", "hop_fire"), smi)
        check_path_snr(label, torch.cat([yb[0], ya]), x[0], irs[0], smi)
        print(f"{label}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"[{smi}]", flush=True)

    handoff("handoff-two-tier", mono.init_block_state, mono.stream_state_from_block)
    handoff("handoff-collapsed", mono.init_state, mono.stream_state_from_aligned)
    del ir, xd
    torch.cuda.empty_cache()


SERVE_PRE_SWAP = 32     # complete callbacks before the loader thread starts
SERVE_CAPACITY = 1 << 19  # the server's IR capacity once 480 000 taps are set


def _callback_rows(srv, x, start: int, count: int, wrap: int, rows: list) -> int:
    """``count`` complete audio callbacks through the server: a host block
    in, the output copied back to the host. Each row holds the input's
    channel 0, the output, ``live``, the state's IR version and the host ms
    from the call to the output on the host. Input positions wrap below
    ``wrap``; returns the next position."""
    pos = start
    for _ in range(count):
        if pos + CALLBACK > wrap:
            pos = CALLS * CALLBACK
        blk = x[:, pos:pos + CALLBACK]
        t0 = time.perf_counter()
        y, live = srv.process(blk)
        out = y.cpu()
        rows.append((blk[0], out, live, srv._state_version,
                     (time.perf_counter() - t0) * 1e3))
        pos += CALLBACK
    return pos


def serving_paths(dev, irs, irs2, x, launches, smi) -> None:
    """Phases 11a and 11b: the StreamingServer at full width (a WAV read back
    by AudioBlockReader through the native codec, an IR hot swap from a
    loader thread) and checkpoint resume at its shape."""
    import tempfile
    import threading

    from hisstools_library_tpu_torch.io import FileType, OAudioFile, PCMFormat
    from hisstools_library_tpu_torch.io.streaming import AudioBlockReader
    from hisstools_library_tpu_torch.models import mono
    from hisstools_library_tpu_torch.utils import native_rt
    from hisstools_library_tpu_torch.utils.serving import StreamingServer

    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    n = CALLS * CALLBACK
    launches.reset()
    torch.cuda.reset_peak_memory_stats()
    srv = StreamingServer(CHANNELS, latency=mono.LatencyMode.Zero, native=True, device=dev)
    t0 = time.perf_counter()
    v1 = srv.set_ir(irs)
    set_ir_ms = (time.perf_counter() - t0) * 1e3
    if srv.capacity != SERVE_CAPACITY:
        fail(f"serving: capacity {srv.capacity} after {IR_LEN} taps, not {SERVE_CAPACITY}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "signal.wav")
        with OAudioFile(path, FileType.WAVE, PCMFormat.Float32, CHANNELS, float(FS)) as f:
            f.write_interleaved(x[:, :n].T)
            if f.get_is_error():
                fail(f"serving: writing the WAV failed: {f.get_errors()}")
        with AudioBlockReader(path, CALLBACK, native=True) as reader:
            blocks = list(reader)  # (CALLBACK, CHANNELS) float32 each
    if not np.array_equal(np.concatenate(blocks).T, x[:, :n]):
        fail("serving: the WAV read back differs from the signal written")
    ys, host_ms, lives = [], [], []
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for blk in blocks:
        t0 = time.perf_counter()
        y, live = srv.process(blk.T)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ys.append(y)
        lives.append(live)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / CALLS
    launches.read("serving", ("hop_fire", "rifft_packed", "rfft_packed", "rfft_small"), smi)
    if not all(lives):
        fail("serving: a callback was silent with no loader running")
    y_srv = torch.cat(ys, dim=-1)
    del ys
    check_path_snr("serving", y_srv[0], x[0], irs[0], smi)
    print(f"serving: StreamingServer({CHANNELS}, Zero preset, native=True), swap cell "
          f"{type(srv._swap).__name__} (native runtime {native_rt.available()}); set_ir "
          f"{set_ir_ms:.2f} ms ({IR_LEN} taps, capacity {srv.capacity}); {CALLS} callbacks "
          f"of {CALLBACK} samples from the WAV (AudioBlockReader, native codec): "
          f"{ms:.4f} ms/callback (CUDA events over the {CALLS}), host "
          f"{float(np.mean(host_ms)):.4f} ms/call mean, {float(np.median(host_ms)):.4f} "
          f"median, {max(host_ms):.4f} max (enqueue, no sync); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]", flush=True)

    # The same blocks through process_any on the capacity-padded IR.
    padded = np.zeros((CHANNELS, srv.capacity), np.float32)
    padded[:, :IR_LEN] = irs
    ir_direct = mono.prepare_ir(zero, padded, offline_tail=False, device=dev)
    del padded
    state = mono.init_stream_state(zero, ir_direct, (CHANNELS,))
    ys = []
    for blk in blocks:
        state, y = mono.process_any(ir_direct, state,
                                    torch.from_numpy(np.ascontiguousarray(blk.T)).to(dev))
        ys.append(y)
    y_direct = torch.cat(ys, dim=-1)
    del ys, state
    if not torch.equal(y_srv, y_direct):
        fail(f"serving: the server differs from process_any on the padded IR (max abs "
             f"{float((y_srv - y_direct).abs().max()):.3e})")
    print(f"serving: output equals process_any on the capacity-padded IR, bit for bit, "
          f"{CALLS} callbacks x {CHANNELS} channels [{smi}]", flush=True)
    del y_srv

    # The silence path: the loader holds the cell, the audio thread gets zeros.
    handle = srv._swap.access()
    y, live = srv.process(x[:, n:n + CALLBACK])
    handle.release()
    if live or bool(y.any()):
        fail("serving: a callback while the cell was held was not silent")

    # Hot swap: a loader thread sets the second bank while the audio thread
    # keeps calling; complete callbacks (host block in, output on the host).
    rows: list = []
    pos = _callback_rows(srv, x, n, SERVE_PRE_SWAP, x.shape[1], rows)
    pre = len(rows)
    loader = {}

    def load():
        t0 = time.perf_counter()
        loader["version"] = srv.set_ir(irs2)
        loader["ms"] = (time.perf_counter() - t0) * 1e3

    th = threading.Thread(target=load)
    th.start()
    while th.is_alive():
        pos = _callback_rows(srv, x, pos, 1, x.shape[1], rows)
    th.join()
    during = len(rows) - pre
    pos = _callback_rows(srv, x, pos, CALLS, x.shape[1], rows)
    v2 = loader.get("version")
    if v2 != v1 + 1:
        fail(f"serving: the loader's set_ir gave version {v2}, not {v1 + 1}")
    silent = [r for r in rows if not r[2]]
    if any(bool(r[1].any()) for r in silent):
        fail("serving: a live=False callback was not zeros")
    reset = next((i for i, r in enumerate(rows) if r[2] and r[3] == v2), None)
    if reset is None or len(rows) - reset < CALLS:
        fail("serving: fewer than CALLS live callbacks after the swap")
    post = rows[reset:]
    if not all(r[2] and r[3] == v2 for r in post):
        fail("serving: a callback after the swap's reset point was silent or stale")
    x0 = np.concatenate([r[0] for r in post])
    check_path_snr("serving-after-swap", torch.cat([r[1][0] for r in post]), x0,
                   irs2[0], smi)
    period = CALLBACK / FS * 1e3

    def summary(ms):
        late = sum(m > period for m in ms)
        return (f"{float(np.median(ms)):.4f} ms median, {max(ms):.4f} max, {late} of "
                f"{len(ms)} over the {period:.2f} ms period")

    print(f"serving-swap: swap cell {type(srv._swap).__name__}; loader set_ir "
          f"{loader['ms']:.2f} ms; complete callbacks (host block in, output on the "
          f"host): before the swap {summary([r[4] for r in rows[:pre]])}; while the "
          f"loader prepares {summary([r[4] for r in rows[pre:pre + during]] or [0.0])}; "
          f"after {summary([r[4] for r in rows[pre + during:]])}; {len(silent)} silent "
          f"callbacks (all zeros); state reset at callback {reset - pre} after the loader "
          f"started [{smi}]", flush=True)
    del rows, post, srv
    torch.cuda.empty_cache()
    checkpoint_paths(dev, zero, blocks, ir_direct, y_direct, launches, smi)


def checkpoint_paths(dev, zero, blocks, ir, y_ref, launches, smi) -> None:
    """Phase 11b: CALLS / 2 callbacks of process_any at the serving shape,
    the state and the MonoIR checkpointed (``save`` / ``restore``, then
    ``save_npz`` / ``restore_npz``) and restored into fresh exemplars on the
    card, CALLS / 2 more; the output must equal the uninterrupted stream
    ``y_ref`` bit for bit."""
    import tempfile

    from hisstools_library_tpu_torch.models import mono
    from hisstools_library_tpu_torch.utils import checkpoint

    half = CALLS // 2
    host = [torch.from_numpy(np.ascontiguousarray(blk.T)) for blk in blocks]
    for fmt, save, restore in (("torch", checkpoint.save, checkpoint.restore),
                               ("npz", checkpoint.save_npz, checkpoint.restore_npz)):
        label = f"checkpoint-{fmt}"
        launches.reset()
        state = mono.init_stream_state(zero, ir, (CHANNELS,))
        ys = []
        for blk in host[:half]:
            state, y = mono.process_any(ir, state, blk.to(dev))
            ys.append(y)
        payload = {"state": state, "ir": ir}
        like = checkpoint.rebuild(payload, [torch.empty_like(t) if isinstance(t, torch.Tensor)
                                            else t for t in checkpoint.leaves(payload)])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"ck.{fmt}")
            t0 = time.perf_counter()
            save(path, payload)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            restored = restore(path, like)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        del payload, like, state
        rir, state = restored["ir"], restored["state"]
        if rir.head_taps.device != dev or state.head.device != dev:
            fail(f"{label}: restored tensors are not on {dev}")
        for blk in host[half:]:
            state, y = mono.process_any(rir, state, blk.to(dev))
            ys.append(y)
        torch.cuda.synchronize()
        launches.read(label, ("hop_fire", "rifft_packed", "rfft_packed"), smi)
        y = torch.cat(ys, dim=-1)
        if not torch.equal(y, y_ref):
            fail(f"{label}: resumed stream differs from the uninterrupted one (max abs "
                 f"{float((y - y_ref).abs().max()):.3e})")
        print(f"{label}: {half} + {half} callbacks, state and MonoIR "
              f"({size / 2**30:.3f} GiB) saved in {save_s:.2f} s, restored onto the card in "
              f"{restore_s:.2f} s; resumed output equals the uninterrupted stream bit for "
              f"bit [{smi}]", flush=True)
        del restored, rir, state, ys, y
        torch.cuda.empty_cache()


# The JAX tests' inputs (tests/conftest.py's rng seed) and schemes.
STAGE_SEED = 0x1557


def stage_report_paths(dev, irs, x, launches, smi) -> None:
    """Phase 11c: the per-stage SNR reports on the card, each with the
    kernels it launched, held to the JAX tests' bars."""
    from hisstools_library_tpu_torch.models import mono
    from hisstools_library_tpu_torch.utils import debug_stages as ds

    def run(label, call, need, stages, bar):
        launches.reset()
        t0 = time.perf_counter()
        report = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches.read(label, need, smi)
        print(f"{label} ({secs:.2f} s, float64 oracles included):\n"
              f"{ds.format_report(report)} [{smi}]", flush=True)
        got = {s.stage: s.snr_db for s in report}
        if not set(stages) <= set(got):
            fail(f"{label}: stages {sorted(set(stages) - set(got))} missing")
        for stage, db in got.items():
            need_db = bar(stage)
            if need_db is not None and not db > need_db:
                fail(f"{label}: {stage} {db:.2f} dB <= {need_db}")

    xd = torch.from_numpy(np.ascontiguousarray(x[:4, :1 << 17])).to(dev)
    run("stage-report", lambda: ds.stage_report(irs[:4, :1 << 15], xd),
        ("rfft_packed", "lag_mac_ring", "rifft_packed_tail"),
        ("impulse_spectra", "hop_rfft", "partition_mac", "rifft_overlap", "engine_output"),
        lambda s: 95.0)

    rng = np.random.default_rng(STAGE_SEED)
    scheme = mono.PartitionScheme((256, 1024), zero_latency=True)
    b = scheme.sizes[-1] >> 1
    ir = (rng.standard_normal((2, 3000)) * 0.3).astype(np.float32)
    xw = rng.standard_normal((2, 2 * b)).astype(np.float32)
    xb = torch.from_numpy(rng.standard_normal((2, 2 * b)).astype(np.float32)).to(dev)
    run("stream-stage-report",
        lambda: ds.stream_stage_report(ir, xw, xb, scheme=scheme),
        ("rfft_small", "lag_mac_ring", "hop_fire"),
        ("frame_rfft", "ring_mac", "lag0_product", "rifft_tail", "section_refresh",
         "collapsed_output", "subhop_fire", "subhop_doling"),
        lambda s: 200.0 if s == "subhop_doling" else 95.0)

    rng = np.random.default_rng(STAGE_SEED)
    scheme = mono.PartitionScheme((32, 64, 128, 256), zero_latency=True)
    ir = (rng.standard_normal((2, 4096)) * 0.3).astype(np.float32)
    h2 = mono.prepare_ir(scheme, ir, offline_tail=False, device="cpu").far.shape[-1]
    xw = rng.standard_normal((2, 2 * h2)).astype(np.float32)
    xb = torch.from_numpy(rng.standard_normal((2, h2)).astype(np.float32)).to(dev)
    run("two-tier-stage-report",
        lambda: ds.two_tier_stage_report(ir, xw, xb, scheme=scheme),
        ("rfft_small", "rifft_small"),
        ("near_block", "far_block", "two_tier_output", "handoff_continuation"),
        lambda s: 90.0)

    rng = np.random.default_rng(STAGE_SEED)
    t = np.arange(16384) / 48000.0
    exc = np.sin(2 * np.pi * (20.0 * (1000.0 ** (t / t[-1]))) * t)
    measured = np.convolve(exc, rng.standard_normal(1024) * np.exp(-np.arange(1024) / 1200.0))
    run("pipeline-stage-report",
        lambda: ds.pipeline_stage_report(measured, exc, regularization=1e-9, stft_size=256,
                                         stft_hop=128, n_peaks=8, device=dev),
        ("rfft_packed", "rifft_packed", "rfft_small_windowed"),
        ("deconvolve", "stft_amp", "smooth", "peaks", "track", "stft_amp cum",
         "smooth cum", "track cum"),
        lambda s: {"stft_amp": 80.0, "smooth": 80.0, "peaks": 80.0,
                   "deconvolve": 50.0}.get(s))
    torch.cuda.empty_cache()


def offline_paths(dev, irs, x, launches, smi) -> None:
    """Phases 12 and 13: mono.process_offline with and without the offline
    tail, and the staged FastFIR at N = 2048."""
    from hisstools_library_tpu_torch.models import mono
    from hisstools_library_tpu_torch.models.offline import FastFIR

    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    xd = torch.from_numpy(x).to(dev)
    for label, tail, need, forbid in (
            ("offline-tail", True, ("rfft_packed", "fastfir_chain"), STAGED),
            ("offline-no-tail", False, ("rifft_small", "fastfir_chain") + STAGED, ())):
        launches.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ir = mono.prepare_ir(zero, irs, offline_tail=tail, device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        y = mono.process_offline(ir, xd)
        torch.cuda.synchronize()
        launches.read(label, need, smi, forbid)
        if tuple(y.shape) != (CHANNELS, SIG_LEN):
            fail(f"{label}: output shape {tuple(y.shape)}")
        check_path_snr(label, y[0], x[0], irs[0], smi)
        del y
        ms = median_ms(lambda: mono.process_offline(ir, xd), runs=3)
        print(f"{label}: tail {None if ir.tail is None else tuple(ir.tail.shape)}, IR prep "
              f"{prep_s:.3f} s, {ms:.4f} ms/pass (CUDA events, median of 3 after a "
              f"warm-up), {CHANNELS * SIG_LEN / (ms * 1e-3):.6e} samples/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]", flush=True)
        del ir
        torch.cuda.empty_cache()

    launches.reset()
    eng = FastFIR(irs[:, :STAGED_TAPS], fft_size=STAGED_N, device=dev)
    xs = xd[:, :FS].contiguous()
    y = eng(xs)
    torch.cuda.synchronize()
    launches.read("staged-offline", ("rfft_small", "lag_mac_ring", "rifft_small"), smi,
                  forbid=("lag_mac",))
    check_path_snr("staged-offline", y[0], x[0], irs[0, :STAGED_TAPS], smi)
    ms = median_ms(lambda: eng(xs), runs=3)
    print(f"staged-offline: FastFIR N={eng.fft_size}, P={eng.spectra.shape[-2]}, "
          f"{CHANNELS} x {FS} samples, {ms:.4f} ms/pass (CUDA events, median of 3), "
          f"{CHANNELS * FS / (ms * 1e-3):.6e} samples/s [{smi}]", flush=True)
    del eng, y, xs, xd
    torch.cuda.empty_cache()


def pass_rates(label, fn, frame_bytes: int, smi: str) -> dict:
    """Device ms of each pass (CUDA kernel) ``fn`` launches, by
    ``torch.profiler``, and the rate it reaches: every pass of K12-K14 reads
    and writes one complex frame per transform (the packed planes of K13's
    output and K14's input are a frame's size too), so 2 * ``frame_bytes``
    over its time."""
    ms = phase_ms(fn, smi, label)
    out = {k: dict(ms=v, tb_per_s=2 * frame_bytes / (v * 1e-3) / 1e12) for k, v in ms.items()}
    print(f"{label} passes: " + "; ".join(
        f"{k.split('(')[0]} {v['ms']:.4f} ms at {v['tb_per_s']:.3f} TB/s"
        for k, v in out.items()) + f" [{smi}]", flush=True)
    return out


def spectral_kernels(randn, mods, smi) -> dict:
    """Phase 14: K12, K13 and K14. Path shapes: K12 at (128, 2^17), forward
    and inverse (the complex ops of 65 536-sample signals); K13 and K14 at
    (128, 2^20) (a 10 s x 10 s convolution). Small and edge shapes: K12 at
    (3, 1024) (shared memory), (2, 2^14) (two passes), (1, 2^17) (one
    cluster), (2, 2^18) and (3, 2^19) (two long passes); K13 and K14 at
    (1, 2^19), (2, 2^18), (1, 2^18) and (5, 2^18) (the cluster). At the path
    shapes each pass's device ms and TB/s."""
    def cplx(b, n, inverse):
        return lambda: ((randn(b, n), randn(b, n)), dict(inverse=inverse))

    def real(b, n):
        return lambda: ((randn(b, n),), {})

    def packed(b, n):
        return lambda: ((randn(b, n // 2), randn(b, n // 2)), {})

    results = check_kernels([
        ("fft_split", [(cplx(3, 1024, False), False), (cplx(2, 1 << 14, True), False),
                       (cplx(1, 1 << 17, False), False), (cplx(2, 1 << 18, True), False),
                       (cplx(3, 1 << 19, False), False),
                       (cplx(CHANNELS, 1 << 17, False), True),
                       (cplx(CHANNELS, 1 << 17, True), True)]),
        ("rfft_packed_split", [(real(1, 1 << 19), False), (real(2, 1 << 18), False),
                               (real(1, 1 << 18), False), (real(5, 1 << 18), False),
                               (real(CHANNELS, 1 << 20), True)]),
        ("rifft_packed_split", [(packed(1, 1 << 19), False), (packed(2, 1 << 18), False),
                                (packed(1, 1 << 18), False), (packed(5, 1 << 18), False),
                                (packed(CHANNELS, 1 << 20), True)]),
    ], mods, smi)
    hf = mods["hopper_fft"]
    n = 1 << 17
    (re, im), _ = cplx(CHANNELS, n, False)()
    results["fft_split"]["phase_ms"] = pass_rates(
        "fft_split (128, 2^17)", lambda: hf.fft_split(re, im), 8 * n * CHANNELS, smi)
    del re, im
    n = 1 << 20
    (x,), _ = real(CHANNELS, n)()
    results["rfft_packed_split"]["phase_ms"] = pass_rates(
        "rfft_packed_split (128, 2^20)", lambda: hf.rfft_packed_split(x), 4 * n * CHANNELS,
        smi)
    pr, pi = hf.rfft_packed_split(x)
    del x
    results["rifft_packed_split"]["phase_ms"] = pass_rates(
        "rifft_packed_split (128, 2^20)", lambda: hf.rifft_packed_split(pr, pi),
        4 * n * CHANNELS, smi)
    del pr, pi
    torch.cuda.empty_cache()
    return results


def _f64_linear(a: np.ndarray, b: np.ndarray, size: int, correlate: bool) -> np.ndarray:
    """Circular convolution (or correlation, a * conj(b)) of size ``size`` in
    float64; complex inputs stay complex. With size >= len(a) + len(b) - 1
    it holds the linear result, negative lags -d at size - d."""
    if np.iscomplexobj(a) or np.iscomplexobj(b):
        fa, fb = np.fft.fft(a, size), np.fft.fft(b, size)
        return np.fft.ifft(fa * (np.conj(fb) if correlate else fb))
    fa, fb = np.fft.rfft(a.astype(np.float64), size), np.fft.rfft(b.astype(np.float64), size)
    return np.fft.irfft(fa * (np.conj(fb) if correlate else fb), size)


def path_run(label, call, need, ref0, launches, smi, bar=SNR_MIN_PATH_DB) -> None:
    """One call of a spectral path with the counts from 0 (launches, SNR of
    channel 0 against ``ref0``, a float64 mirror), then the timed calls (ms
    per call, peak memory)."""
    from hisstools_library_tpu_torch.core.types import Split
    launches.reset()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    launches.read(label, need, smi)
    planes = (out.re, out.im) if isinstance(out, Split) else (out,)
    if not all(bool(torch.isfinite(p).all()) for p in planes):
        fail(f"{label}: non-finite output")
    got0 = np.concatenate([p[0].double().cpu().numpy() for p in planes])
    want0 = np.concatenate([ref0.real, ref0.imag]) if np.iscomplexobj(ref0) else ref0
    if got0.shape != want0.shape:
        fail(f"{label}: channel 0 has {got0.shape} samples, the mirror {want0.shape}")
    snr = snr_db(torch.from_numpy(want0), torch.from_numpy(got0))
    channels = planes[0].shape[0]
    del out, planes
    ms = median_ms(call)
    print(f"{label}: {channels} channels, SNR vs float64 (ch0) {snr:.2f} dB "
          f"(bar {bar:.2f}); {ms:.4f} ms/call (CUDA events, median of 5 after a "
          f"warm-up), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{smi}]", flush=True)
    if not snr >= bar:
        fail(f"{label}: SNR {snr:.2f} dB < {bar:.2f}")
    torch.cuda.empty_cache()


def sweep_capture(dev, ird, rate: int, sweep_len: int, cap_len: int):
    """A log sweep of ``sweep_len`` samples (20 Hz - 20 kHz at ``rate``) and
    its capture through the IRs ``ird`` (the linear convolution cut at
    ``cap_len``, built in float64 on the card), with the float64 numpy mirror
    of ``ir_deconvolve`` for channel 0 (reg 1e-4): (capture, sweep float32,
    mirror)."""
    t = np.arange(sweep_len) / rate
    f1, f2, dur = 20.0, 20000.0, sweep_len / rate
    lr = np.log(f2 / f1)
    sweep = np.sin(2 * np.pi * f1 * dur / lr * (np.exp(t * lr / dur) - 1.0))
    size = 1 << (sweep_len + ird.shape[-1] - 2).bit_length()
    sw = torch.fft.rfft(torch.from_numpy(sweep).to(dev), size)
    capture = torch.empty(ird.shape[0], cap_len, device=dev)
    for i in range(0, ird.shape[0], 16):
        spec = torch.fft.rfft(ird[i:i + 16].double(), size) * sw
        capture[i:i + 16] = torch.fft.irfft(spec, size)[:, :cap_len].float()
    del sw, spec
    cap0 = capture[0].double().cpu().numpy()
    nd = 1 << (max(cap_len, sweep_len) - 1).bit_length()
    Y = np.fft.rfft(cap0, nd)
    X = np.fft.rfft(sweep.astype(np.float32).astype(np.float64), nd)
    power = (X * X.conj()).real
    ref = np.fft.irfft(Y * X.conj() / (power + 1e-4 * power.max()), nd)
    return capture, torch.from_numpy(sweep.astype(np.float32)).to(dev), ref


def spectral_paths(dev, irs, x, launches, smi) -> None:
    """Phase 15: the spectral layer at 128 channels (see the module
    docstring); each sub-phase with every launch count set to 0 before it."""
    from hisstools_library_tpu_torch.core.types import Split
    from hisstools_library_tpu_torch.models import pipeline
    from hisstools_library_tpu_torch.ops import spectral_processor as sp

    sig = torch.from_numpy(np.ascontiguousarray(x[:, :IR_LEN])).to(dev)
    ird = torch.from_numpy(irs).to(dev)
    short = ird[:, :STAGED_TAPS].contiguous()
    sig_np = x[0, :IR_LEN].astype(np.float64)
    k13k14 = ("rfft_packed_split", "rifft_packed_split")

    def run(label, call, need, ref0, bar=SNR_MIN_PATH_DB):
        path_run(label, call, need, ref0, launches, smi, bar)

    # (a) Linear convolution of each IR with its channel's 10 s signal, N = 2^20.
    n_lin = 2 * IR_LEN - 1
    run("spectral-convolve", lambda: sp.convolve(sig, ird), k13k14 + ("bin_mul",),
        convolve_f64(sig_np, irs[0], n_lin))

    # (b) Wrap correlation and Fold convolution with the first 48 000 taps.
    h0 = irs[0, :STAGED_TAPS].astype(np.float64)
    s1, s2 = IR_LEN, STAGED_TAPS
    c = _f64_linear(sig_np, h0, 1 << 20, correlate=True)
    wrap = c[:s1].copy()
    wrap[s1 - (s2 - 1):] += c[(1 << 20) - (s2 - 1):]
    run("spectral-correlate-wrap",
        lambda: sp.correlate(sig, short, sp.EdgeMode.Wrap), k13k14 + ("bin_mul_conj",), wrap)
    fold = s2 >> 1
    padded = np.concatenate([sig_np[1:fold + 1][::-1], sig_np,
                             sig_np[s1 - fold - 1:s1 - 1][::-1]])
    lin = _f64_linear(padded, h0, 1 << 21, correlate=False)
    run("spectral-convolve-fold",
        lambda: sp.convolve(sig, short, sp.EdgeMode.Fold), k13k14 + ("bin_mul",),
        lin[s2 - 1:s2 - 1 + s1])
    del short

    # (c) Complex convolution and correlation of 65 536-sample signals, N = 2^17.
    m = 1 << 16
    z1 = Split(sig[:, :m].contiguous(), sig[:, m:2 * m].contiguous())
    z2 = Split(ird[:, :m].contiguous(), ird[:, m:2 * m].contiguous())
    a0 = x[0, :m].astype(np.float64) + 1j * x[0, m:2 * m]
    b0 = irs[0, :m].astype(np.float64) + 1j * irs[0, m:2 * m]
    run("spectral-convolve-complex", lambda: sp.convolve_complex(z1, z2), ("fft_split",),
        _f64_linear(a0, b0, 1 << 18, correlate=False)[:2 * m - 1])
    if launches.by_path["spectral-convolve-complex"]["fft_split"] != 3:
        fail("spectral-convolve-complex: K12 did not launch 3 times")
    cc = _f64_linear(a0, b0, 1 << 18, correlate=True)
    run("spectral-correlate-complex", lambda: sp.correlate_complex(z1, z2), ("fft_split",),
        np.concatenate([cc[:m], cc[(1 << 18) - (m - 1):]]))
    if launches.by_path["spectral-correlate-complex"]["fft_split"] != 3:
        fail("spectral-correlate-complex: K12 did not launch 3 times")
    del z1, z2

    # (d) change_phase of the IRs, N = 2^19, against the float64 CPU path.
    ir0 = torch.from_numpy(irs[:1])
    for phase in (0.0, 0.25):
        ref = sp.change_phase(ir0.double(), phase)[0].numpy()
        plain = snr_db(torch.from_numpy(ref), sp.change_phase(ir0, phase)[0])
        bar = SNR_MIN_PATH_DB if plain >= SNR_MIN_PATH_DB else plain - 3.0
        print(f"spectral-change-phase-{phase}: plain float32 CPU path SNR vs float64 "
              f"(ch0) {plain:.2f} dB", flush=True)
        run(f"spectral-change-phase-{phase}", lambda: sp.change_phase(ird, phase), k13k14,
            ref, bar)
        for k in k13k14:
            if launches.by_path[f"spectral-change-phase-{phase}"][k] != 2:
                fail(f"spectral-change-phase-{phase}: {k} did not launch twice")

    # (e) ir_deconvolve of a 12 s capture: a 10 s log sweep through the IRs
    # plus a 2 s tail (built in float64 on the card, outside the timing).
    capture, sweep32, ref = sweep_capture(dev, ird, FS, IR_LEN, IR_LEN + 2 * FS)
    run("spectral-ir-deconvolve", lambda: pipeline.ir_deconvolve(capture, sweep32),
        k13k14 + ("bin_deconvolve", "bin_floor"), ref)
    del capture, sweep32

    # (f) 1 s x 1 s convolution, N = 2^17: K1 (one pass) and K6 (two passes).
    s1 = sig[:, :FS].contiguous()
    h1 = ird[:, :FS].contiguous()
    run("spectral-convolve-1s", lambda: sp.convolve(s1, h1),
        ("rfft_packed", "rifft_packed", "bin_mul"),
        convolve_f64(x[0, :FS], irs[0, :FS], 2 * FS - 1))
    del s1, h1, sig, ird
    torch.cuda.empty_cache()


def bin_kernels(randn, mods, smi) -> dict:
    """Phase 14b (see the module docstring): K16 against its plain versions
    and its times at the two path shapes."""
    def pair(a_lead, b_lead, k, extra):
        def make():
            planes = [randn(*lead, k) for lead in (a_lead, a_lead, b_lead, b_lead)]
            return tuple(planes) + extra(k), {}
        return make

    def conv(k):
        return (0.25 / (2 * k),)

    def deconv(k):
        return (1e-4, 0.5 / (2 * k))

    def floor(lead, k):
        return lambda: ((randn(*lead, k), randn(*lead, k), 1e-4), {})

    c, kc, kd = CHANNELS, 1 << 20, 1 << 21
    results = check_kernels([
        ("bin_mul", [(pair((c,), (c,), kc, conv), True), (pair((3,), (3,), 6, conv), False),
                     (pair((1,), (5,), 4100, conv), False), (pair((c,), (c,), kd, conv), False)]),
        ("bin_mul_conj", [(pair((c,), (c,), kc, conv), True),
                          (pair((2, 3), (1,), 1, conv), False),
                          (pair((c,), (c,), kd, conv), False)]),
        ("bin_deconvolve", [(pair((c,), (), kd, deconv), True),
                            (pair((5,), (5,), 4096, deconv), False),
                            (pair((), (7,), 1000, deconv), False)]),
        ("bin_floor", [(floor((), kd), True), (floor((300,), 4096), False),
                       (floor((3,), 5), False)]),
    ], mods, smi)
    hk = mods["hopper_kernels"]
    for name, k in (("bin_mul", kc), ("bin_mul_conj", kc), ("bin_deconvolve", kd)):
        r = results[name]
        args, _ = r["path_case"]()
        fn = getattr(hk, name)
        r["graph_ms"] = graph_ms(lambda: fn(*args))
        nbytes = 8 * k * (3 * c if name != "bin_deconvolve" else 2 * c + 1)
        r["tb_per_s"] = nbytes / (r["graph_ms"] * 1e-3) / 1e12
        r["bound_share"] = r["bound_ms"] / r["graph_ms"]
        print(f"{name} ({c}, {k}): {r['graph_ms']:.4f} ms a launch in a CUDA graph "
              f"({r['tb_per_s']:.3f} TB/s, {100 * r['bound_share']:.1f}% of its "
              f"{r['bound_ms']:.4f} ms bound), events {r['ms']:.4f} ms, profiler device "
              f"{r['device_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms [{smi}]", flush=True)
        del args
    torch.cuda.empty_cache()
    return results


STFT_N, STFT_HOP, STFT_LEN = 1024, 512, 479744   # bench.py's stft mode: 10 s // hop * hop
PIPE_LEN, PIPE_IR, PIPE_PEAKS = 1 << 17, 4096, 16  # bench.py's pipeline mode


def _hann64(n: int) -> np.ndarray:
    from hisstools_library_tpu_torch.ops import windows
    return windows.hann(n - 1, dtype=torch.float64, device="cpu").numpy()


def windowed_kernels(randn, mods, smi) -> dict:
    """Phase 16: K10w and K11w. Path shapes: the STFT's 128 x 938 frames of
    1024 (hop 512), read as the ``unfold`` view of the padded 128 x 480 768
    signal, and the pipeline's 511 frames of its 2^18-sample IR; K11w on
    spectra of those shapes. Small shapes: (3, 256) contiguous frames, 9
    frames of 1024 at the odd hop 341, the same frames with the view's base
    one float into its signal (K10w's scalar loader), and 11 frames of 32 /
    6 frames of 2048 at hop N/2."""
    def window(n, like):
        return torch.from_numpy(_hann64(n).astype(np.float32)).to(like.device)

    def frames(c, t, n, hop, base=0):
        def make():
            if hop is None:  # contiguous frames
                f = randn(t, n)
            else:
                f = randn(c, base + (t - 1) * hop + n)[:, base:].unfold(-1, n, hop)
            return (f, window(n, f)), {}
        return make

    def spectra(lead, n):
        def make():
            re, im = randn(*lead, n // 2), randn(*lead, n // 2)
            return (re, im, window(n, re), 0.5 / n), {}
        return make

    t_stft = STFT_LEN // STFT_HOP + 1
    t_pipe = (2 * PIPE_LEN - STFT_N) // STFT_HOP + 1
    return check_kernels([
        ("rfft_small_windowed", [(frames(None, 3, 256, None), False),
                                 (frames(2, 9, 1024, 341), False),
                                 (frames(2, 9, 1024, 341, base=1), False),
                                 (frames(3, 11, 32, 16), False),
                                 (frames(2, 6, 2048, 1024), False),
                                 (frames(CHANNELS, t_stft, STFT_N, STFT_HOP), True),
                                 (frames(1, t_pipe, STFT_N, STFT_HOP), True)]),
        ("rifft_small_windowed", [(spectra((3,), 256), False), (spectra((2, 9), 1024), False),
                                  (spectra((CHANNELS, t_stft), STFT_N), True),
                                  (spectra((t_pipe,), STFT_N), True)]),
    ], mods, smi)


def stft_path(dev, launches, smi, profile) -> None:
    """Phase 17: the STFT round trip of bench.py's stft mode."""
    from hisstools_library_tpu_torch.ops import stft as stft_mod

    rng = np.random.default_rng(0)
    x = rng.standard_normal((CHANNELS, STFT_LEN)).astype(np.float32)
    w = _hann64(STFT_N).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)

    def roundtrip():
        S = stft_mod.stft(xd, w, STFT_N, STFT_HOP, boundary=True)
        return stft_mod.istft(S, w, STFT_HOP, length=STFT_LEN, boundary=True)

    launches.reset()
    torch.cuda.reset_peak_memory_stats()
    y = roundtrip()
    torch.cuda.synchronize()
    launches.read("stft", ("rfft_small_windowed", "rifft_small_windowed"), smi)
    if tuple(y.shape) != (CHANNELS, STFT_LEN) or not bool(torch.isfinite(y).all()):
        fail(f"stft: output shape {tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
    snr = snr_db(torch.from_numpy(x[0]), y[0].cpu())
    del y
    ms = median_ms(roundtrip)
    peak = torch.cuda.max_memory_allocated() / 2**30
    wt = torch.from_numpy(w).to(dev)

    def library():
        S = torch.stft(xd, STFT_N, STFT_HOP, window=wt, center=True, return_complex=True)
        return torch.istft(S, STFT_N, STFT_HOP, window=wt, center=True, length=STFT_LEN)

    lib_ms = median_ms(library)
    lib_snr = snr_db(torch.from_numpy(x[0]), library()[0].cpu())
    sps = CHANNELS * STFT_LEN / (ms * 1e-3)
    print(f"stft: {CHANNELS} x {STFT_LEN}, N={STFT_N}, hop {STFT_HOP}, boundary: SNR vs input "
          f"(ch0) {snr:.2f} dB; {ms:.4f} ms/pass (CUDA events, median of 5 after a "
          f"warm-up), {sps:.6e} samples/s, real-time factor {sps / (CHANNELS * FS):.2f}; "
          f"peak memory {peak:.2f} GiB; torch.stft + torch.istft {lib_ms:.4f} ms/pass "
          f"(SNR {lib_snr:.2f} dB) [{smi}]", flush=True)
    if not snr >= SNR_MIN_PATH_DB:
        fail(f"stft: SNR {snr:.2f} dB < {SNR_MIN_PATH_DB}")
    if profile:
        profile_calls(roundtrip, "stft", ms, smi)
    del xd
    torch.cuda.empty_cache()


def _deconv_mirror64(measured: np.ndarray, exc: np.ndarray, reg: float) -> np.ndarray:
    """ir_deconvolve in float64 numpy (as bench.py's oracle)."""
    n = 1 << (max(len(measured), len(exc)) - 1).bit_length()
    Y = np.fft.rfft(measured.astype(np.float64), n)
    X = np.fft.rfft(exc.astype(np.float64), n)
    power = (X * X.conj()).real
    return np.fft.irfft(Y * X.conj() / (power + reg * power.max()), n)


def pipeline_paths(dev, launches, smi, profile) -> None:
    """Phase 18: the config-5 IR pipeline of bench.py's pipeline mode."""
    from hisstools_library_tpu_torch.models import partial_tracker as pt
    from hisstools_library_tpu_torch.models import pipeline

    rng = np.random.default_rng(0)
    t = np.arange(PIPE_LEN) / FS
    exc = np.sin(2 * np.pi * (20.0 * (1000.0 ** (t / t[-1]))) * t)
    ir = rng.standard_normal(PIPE_IR) * np.exp(-np.arange(PIPE_IR) / 4800.0)
    measured = np.convolve(exc, ir)
    reg = 1e-9
    kw = dict(sample_rate=FS, regularization=reg, n_peaks=PIPE_PEAKS, smooth_widths=(1.0, 63.0))
    fkw = dict(kw, stft_size=STFT_N, stft_hop=STFT_HOP)
    m32, e32 = measured.astype(np.float32), exc.astype(np.float32)
    md, ed = torch.from_numpy(m32).to(dev), torch.from_numpy(e32).to(dev)
    cpu32 = [torch.from_numpy(a) for a in (m32, e32)]
    cpu64 = [torch.from_numpy(a) for a in (measured, exc)]
    h64 = _deconv_mirror64(m32, e32, reg)
    inside = (PIPE_IR - STFT_N) // STFT_HOP + 1   # STFT frames inside the IR

    def snr64(want, got):
        return snr_db(torch.from_numpy(np.asarray(want, np.float64)),
                      torch.from_numpy(np.asarray(got, np.float64)))

    def ir_check(label, got, plain, mirror=h64):
        snr, plain_snr = snr64(mirror, got), snr64(mirror, plain)
        bar = SNR_MIN_PATH_DB if plain_snr >= SNR_MIN_PATH_DB else plain_snr - 3.0
        print(f"{label}: IR SNR vs the float64 numpy mirror {snr:.2f} dB (bar {bar:.2f}; the "
              f"port's plain float32 CPU path {plain_snr:.2f} dB) [{smi}]", flush=True)
        if not snr >= bar:
            fail(f"{label}: IR SNR {snr:.2f} dB < {bar:.2f}")

    def field_check(label, name, want, got, plain=None):
        snr = snr64(want, got)
        bar = SNR_MIN_PATH_DB if plain is None else min(SNR_MIN_PATH_DB, snr64(want, plain) - 3.0)
        txt = "" if plain is None else f"; the plain float32 CPU path {snr64(want, plain):.2f} dB"
        print(f"{label}: {name} SNR vs the float64 CPU run {snr:.2f} dB (bar {bar:.2f}{txt})",
              flush=True)
        if not (snr >= bar and np.all(np.isfinite(got))):
            fail(f"{label}: {name} SNR {snr:.2f} dB < {bar:.2f}")

    # The multi-frame chain.
    launches.reset()
    torch.cuda.reset_peak_memory_stats()
    got = pipeline.run_ir_pipeline_frames(md, ed, **fkw)
    launches.read("pipeline-frames", ("rfft_packed_split", "rifft_packed_split",
                                      "rfft_small_windowed"), smi)
    want = pipeline.run_ir_pipeline_frames(*cpu64, **fkw)
    ir_check("pipeline-frames", got.impulse,
             pipeline.run_ir_pipeline_frames(*cpu32, **fkw).impulse)
    field_check("pipeline-frames", "smoothed spectra", want.smoothed_amp, got.smoothed_amp)
    for name in ("peak_freqs", "peak_amps"):
        field_check("pipeline-frames", f"{name} of the {inside} frames inside the IR",
                    getattr(want, name)[:inside], getattr(got, name)[:inside])
    same = float(np.mean(want.track_states == got.track_states))
    active = int((got.track_states != pt.OFF).any(axis=-1).sum())
    frames = got.track_states.shape[0]
    print(f"pipeline-frames: {frames} frames, {active} with active partials; (frame, track) "
          f"states equal to the float64 CPU run's: {same:.4f} of all, the {inside} frames "
          f"inside the IR {np.array_equal(want.track_states[:inside], got.track_states[:inside])}"
          f" [{smi}]", flush=True)
    if not np.array_equal(want.track_states[:inside], got.track_states[:inside]):
        fail("pipeline-frames: track states inside the IR differ from the float64 run")
    ms = median_ms(lambda: pipeline.run_ir_pipeline_frames(md, ed, **fkw))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        profile_calls(lambda: pipeline.run_ir_pipeline_frames(md, ed, **fkw),
                      "pipeline-frames", ms, smi, calls=1)

    # The tracker loop alone: graph replays, and the eager loop beside it.
    cfg = pt.TrackerConfig(max_peaks=PIPE_PEAKS, max_tracks=PIPE_PEAKS)
    _, _, freqs, amps, _, _, _ = pipeline._frames_chain(
        md, ed, FS, reg, (1.0, 63.0), pipeline._default_kernel(), PIPE_PEAKS, STFT_N, STFT_HOP,
        cfg, 0.0, None, None)
    n_valid = (amps > 0.0).sum(dim=-1)
    track_ms = median_ms(lambda: pipeline._track_frames(cfg, freqs, amps, n_valid, 0.0), runs=3)

    eager_frames = 64

    def eager():
        st = pt.TrackerState.init(PIPE_PEAKS, freqs.dtype, dev)
        for i in range(eager_frames):
            st, _ = pt.process(cfg, st, freqs[i], amps[i], n_valid[i], 0.0)

    eager_ms = median_ms(eager, runs=1)
    print(f"pipeline-frames: {ms:.4f} ms/pass (CUDA events, median of 5 after a warm-up; "
          f"results copied to the host), {PIPE_LEN / (ms * 1e-3):.6e} samples/s; tracker "
          f"{track_ms / frames:.4f} ms/frame as CUDA graph replays ({track_ms:.4f} ms for "
          f"{frames} frames, capture included), eager loop {eager_ms / eager_frames:.4f} "
          f"ms/frame (first {eager_frames} frames); peak memory {peak:.2f} GiB [{smi}]",
          flush=True)

    # The whole-IR chain on the same capture.
    launches.reset()
    got = pipeline.run_ir_pipeline(md, ed, **kw)
    launches.read("pipeline", ("rfft_packed_split", "rifft_packed_split"), smi)
    want = pipeline.run_ir_pipeline(*cpu64, **kw)
    ir_check("pipeline", got.impulse, pipeline.run_ir_pipeline(*cpu32, **kw).impulse)
    field_check("pipeline", "smoothed spectrum", want.smoothed_amp, got.smoothed_amp)
    for name in ("peak_freqs", "peak_amps"):
        field_check("pipeline", name, getattr(want, name), getattr(got, name))
    ms = median_ms(lambda: pipeline.run_ir_pipeline(md, ed, **kw))
    if profile:
        profile_calls(lambda: pipeline.run_ir_pipeline(md, ed, **kw), "pipeline", ms, smi)
    print(f"pipeline: whole-IR chain {ms:.4f} ms/pass (CUDA events, median of 5 after a "
          f"warm-up), {PIPE_LEN / (ms * 1e-3):.6e} samples/s [{smi}]", flush=True)
    del md, ed

    # The frame chain on a 20 Hz - 20 kHz exponential sweep of the same length
    # through the same IR. Its bins above 20 kHz hold almost no excitation, so
    # the regularised division amplifies float32 rounding there on any
    # device: the IR and spectra are held to the plain float32 CPU path's own
    # SNR less 3 dB where that is below 99.
    dur, k = PIPE_LEN / FS, math.log(20000.0 / 20.0)
    sweep = np.sin(2 * np.pi * 20.0 * dur / k * (np.exp(t * k / dur) - 1.0))
    m32, e32 = np.convolve(sweep, ir).astype(np.float32), sweep.astype(np.float32)
    launches.reset()
    got = pipeline.run_ir_pipeline_frames(torch.from_numpy(m32).to(dev),
                                          torch.from_numpy(e32).to(dev), **fkw)
    launches.read("pipeline-frames-log-sweep", ("rfft_packed_split", "rifft_packed_split",
                                                "rfft_small_windowed"), smi)
    plain = pipeline.run_ir_pipeline_frames(*(torch.from_numpy(a) for a in (m32, e32)), **fkw)
    want = pipeline.run_ir_pipeline_frames(*(torch.from_numpy(a).double() for a in (m32, e32)),
                                           **fkw)
    mirror = _deconv_mirror64(m32, e32, reg)
    ir_check("pipeline-frames-log-sweep", got.impulse, plain.impulse, mirror)
    top = np.fft.rfftfreq(len(mirror), 1.0 / FS) > 20000.0

    def top_share(h):  # the share of the IR's error energy above 20 kHz
        err = np.abs(np.fft.rfft(h.astype(np.float64) - mirror)) ** 2
        return float(err[top].sum() / err.sum())

    print(f"pipeline-frames-log-sweep: IR error energy above 20 kHz: {top_share(got.impulse):.6f}"
          f" of the card's, {top_share(plain.impulse):.6f} of the plain float32 CPU path's "
          f"[{smi}]", flush=True)
    field_check("pipeline-frames-log-sweep", "smoothed spectra", want.smoothed_amp,
                got.smoothed_amp, plain.smoothed_amp)
    equal = np.array_equal(want.track_states[:inside], got.track_states[:inside])
    print(f"pipeline-frames-log-sweep: track states of the {inside} frames inside the IR equal "
          f"to the float64 CPU run's {equal}; all (frame, track) states "
          f"{float(np.mean(want.track_states == got.track_states)):.4f} [{smi}]", flush=True)
    if not equal:
        fail("pipeline-frames-log-sweep: track states inside the IR differ from the float64 run")
    torch.cuda.empty_cache()


def convolver_paths(dev, irs, x, launches, smi) -> None:
    """Phase 19: the multichannel Convolver at full width (see the module
    docstring). Each case runs with every launch count set to 0 before it
    and holds output 0 against a float64 FFT convolution."""
    from hisstools_library_tpu_torch.models import mono
    from hisstools_library_tpu_torch.models.multichannel import Convolver

    blk = STREAM_BLOCK
    n2m = 8
    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    single = mono.PartitionScheme.for_latency_budget(65536)

    def mirror(n, lat, ins, taps):
        """Output 0's float64 mirror: sum over inputs of conv(x_i, ir_0i),
        delayed by the scheme's latency ``lat``."""
        ref = sum(convolve_f64(x[i, :n], taps[i], n) for i in ins)
        return np.concatenate([np.zeros(lat), ref[:n - lat]])

    def run(label, need, forbid, call, n, ins, taps, lat=0):
        launches.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y0 = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches.read(label, need, smi, forbid)
        if not bool(torch.isfinite(y0).all()):
            fail(f"{label}: non-finite output")
        snr = snr_db(torch.from_numpy(mirror(n, lat, ins, taps)), y0.cpu())
        ms, times = time_calls(call, runs=3)
        print(f"{label}: SNR vs float64 FFT convolution (output 0, {n} samples) {snr:.2f} "
              f"dB; first call {first_s:.3f} s; {ms:.4f} ms/call (CUDA "
              f"events, median of 3 after a warm-up; all {[round(v, 4) for v in times]}); "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]",
              flush=True)
        if not snr >= SNR_MIN_PATH_DB:
            fail(f"{label}: SNR {snr:.2f} dB < {SNR_MIN_PATH_DB}")
        torch.cuda.empty_cache()

    # (a) parallel, 128 channels, process_offline through the lazy offline tail.
    xd = torch.from_numpy(x).to(dev)
    conv = Convolver(CHANNELS, scheme=zero, device=dev)
    conv.set_all(irs)
    conv.prepare()
    run("convolver-parallel-offline", ("fastfir_chain",), STAGED,
        lambda: conv.process_offline(xd)[0], SIG_LEN, [0], [irs[0]])
    del conv, xd

    # (b) N2M 8 x 8 on the first 64 IRs, process_offline.
    bank = irs[:n2m * n2m].reshape(n2m, n2m, IR_LEN)
    xin = torch.from_numpy(np.ascontiguousarray(x[:n2m])).to(dev)
    conv = Convolver(n2m, n2m, scheme=zero, device=dev)
    conv.set_all(bank)
    conv.prepare()
    run("convolver-n2m-offline", ("fastfir_chain",), STAGED,
        lambda: conv.process_offline(xin)[0], SIG_LEN, range(n2m), bank[0])
    del conv

    # (c) parallel 128, one N = 2^17 section (P = 8): process through K8.
    xs = torch.from_numpy(np.ascontiguousarray(x[:, :3 * blk])).to(dev)
    conv = Convolver(CHANNELS, scheme=single, device=dev)
    conv.set_all(irs)
    conv.prepare(offline_tail=False)
    p = conv.ir.spectra[-1].shape[-2]
    if (single.sizes, p) != ((1 << 17,), 8):
        fail(f"convolver-single-section: sizes {single.sizes}, P {p}; expected 2^17, 8")

    def three_calls(conv, init, ins):
        st = init()
        ys = []
        for i in range(3):
            st, y = conv.process(st, ins[:, i * blk:(i + 1) * blk].contiguous())
            ys.append(y[0])
        return torch.cat(ys)

    run("convolver-single-section", ("fastfir_chain_stream",), STAGED + ("lag_mac_ring",),
        lambda: three_calls(conv, conv.init_state, xs), 3 * blk, [0], [irs[0]],
        lat=single.latency)
    del conv, xs

    # (d) N2M 8 x 8, Zero preset, 290 000 taps, the two-tier block state.
    cut = bank[..., :290000]
    conv = Convolver(n2m, n2m, scheme=zero, device=dev)
    conv.set_all(cut)
    conv.prepare(offline_tail=False)
    if (conv.ir.far.shape[-1], conv.ir.far.shape[-2]) != (1 << 15, 8):
        fail(f"convolver-n2m-two-tier: far tier {tuple(conv.ir.far.shape)}; expected "
             "P2 = 8 at N = 2^16")
    xs = xin[:, :3 * blk].contiguous()
    run("convolver-n2m-two-tier", ("fastfir_chain_stream",), STAGED + ("lag_mac_ring",),
        lambda: three_calls(conv, conv.init_block_state, xs), 3 * blk, range(n2m), cut[0])
    if launches.by_path["convolver-n2m-two-tier"]["fastfir_chain_stream"] != 6:
        fail("convolver-n2m-two-tier: K8 did not launch twice a call (near and far tier)")
    del conv, xs

    # (d2) N2M 8 x 8, Zero preset, 290 000 taps, init_state: the matrix route
    # (K8's matrix form; no per-pair K8), three calls of 131 072 samples.
    conv = Convolver(n2m, n2m, scheme=zero, device=dev)
    conv.set_all(cut)
    conv.prepare(offline_tail=False)
    xs = xin[:, :3 * blk].contiguous()
    run("convolver-n2m-matrix", ("fastfir_chain_stream_matrix",),
        STAGED + ("lag_mac_ring", "fastfir_chain_stream"),
        lambda: three_calls(conv, conv.init_state, xs), 3 * blk, range(n2m), cut[0])
    del conv, xs

    # (e) N2M 2 x 2, 64 callbacks of 256 samples through process_any.
    small = bank[:2, :2]
    conv = Convolver(2, 2, scheme=zero, device=dev)
    conv.set_all(small)
    conv.prepare(offline_tail=False)
    calls = 64
    xa = xin[:2, :calls * CALLBACK].contiguous()

    def callbacks64():
        st = conv.init_stream_state()
        ys = []
        for i in range(calls):
            st, y = conv.process_any(st, xa[:, i * CALLBACK:(i + 1) * CALLBACK])
            ys.append(y[0])
        return torch.cat(ys)

    run("convolver-n2m-process-any", ("hop_fire", "rifft_packed", "rfft_packed"), (),
        callbacks64, calls * CALLBACK, range(2), small[0])
    del conv, xa, xin
    torch.cuda.empty_cache()


def tiny_kernels(randn, mods, smi) -> dict:
    """Phase 20: the FFT sizes below 32 points (``csrc/fft_tiny.cu``, one
    thread a frame) against their plain versions. Times at (128, N) for
    real N = 16, 8, 4, 2 and complex N = 16..1 (both directions), the
    windowed forms on the 16-point STFT's frames of a 128 x 1 s signal (hop
    8, the frames one float into it); small shapes: 257 rows (a ragged last
    block), frames of 4 (hop 2) and 2 (hop 1)."""
    def real(b, n):
        return lambda: ((randn(b, n),), {})

    def packed(b, n):
        return lambda: ((randn(b, n // 2), randn(b, n // 2)), {})

    def cplx(b, n, inverse):
        return lambda: ((randn(b, n), randn(b, n)), dict(inverse=inverse))

    def window(n, like):
        return torch.from_numpy(_hann64(n).astype(np.float32)).to(like.device)

    def frames(c, length, n, hop):
        def make():
            f = randn(c, length)[:, 1:].unfold(-1, n, hop)
            return (f, window(n, f)), {}
        return make

    def spectra(lead, n):
        def make():
            re, im = randn(*lead, n // 2), randn(*lead, n // 2)
            return (re, im, window(n, re), 0.5 / n), {}
        return make

    t16 = (FS - 16) // 8 + 1
    return check_kernels([
        ("rfft_tiny", [(real(CHANNELS, n), True) for n in (16, 8, 4, 2)]
         + [(real(257, 16), False)]),
        ("rifft_tiny", [(packed(CHANNELS, n), True) for n in (16, 8, 4, 2)]
         + [(packed(257, 2), False)]),
        ("rfft_tiny_windowed", [(frames(CHANNELS, FS + 1, 16, 8), True),
                                (frames(3, 1 + 2 * 8 + 4, 4, 2), False),
                                (frames(2, 1 + 9 + 2, 2, 1), False)]),
        ("rifft_tiny_windowed", [(spectra((CHANNELS, t16), 16), True),
                                 (spectra((3, 5), 4), False), (spectra((2,), 2), False)]),
        ("fft_tiny", [(cplx(CHANNELS, n, inverse), True) for n in (16, 8, 4, 2, 1)
                      for inverse in (False, True)]),
    ], mods, smi)


def tiny_paths(dev, launches, smi) -> None:
    """Phase 21: the public calls that pick FFT sizes below 32: (a)
    ``spectral_processor.convolve`` of 128 pairs of 5-sample signals (N = 16:
    K10's tiny form twice, K11's once), (b) ``convolve_complex`` of 128
    pairs of 5-sample complex signals (K12's tiny form three times), (c) the
    STFT round trip with 16-point frames, hop 8, of a 128 x 1 s signal (the
    windowed tiny forms); each against float64 numpy (>= 99 dB), with ms per
    call (CUDA events, median of 5 after a warm-up)."""
    from hisstools_library_tpu_torch.core.types import Split
    from hisstools_library_tpu_torch.ops import spectral_processor as sp
    from hisstools_library_tpu_torch.ops import stft as stft_mod

    rng = np.random.default_rng(11)

    def run(label, need, call, want):
        launches.reset()
        got = call()
        torch.cuda.synchronize()
        launches.read(label, need, smi)
        if tuple(got.shape) != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{label}: output shape {tuple(got.shape)}, expected {want.shape}, finite "
                 f"{bool(torch.isfinite(got).all())}")
        snr = snr_db(torch.from_numpy(want), got.cpu())
        ms = median_ms(call)
        print(f"{label}: SNR vs float64 {snr:.2f} dB; {ms:.4f} ms/call (CUDA events, median "
              f"of 5) [{smi}]", flush=True)
        if not snr >= SNR_MIN_PATH_DB:
            fail(f"{label}: SNR {snr:.2f} dB < {SNR_MIN_PATH_DB}")

    a, b, ai, bi = (rng.standard_normal((CHANNELS, 5)).astype(np.float32) for _ in range(4))
    ad, bd = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    run("small-convolve", ("rfft_tiny", "rifft_tiny"), lambda: sp.convolve(ad, bd),
        np.stack([np.convolve(a[i].astype(np.float64), b[i].astype(np.float64))
                  for i in range(CHANNELS)]))
    z1 = Split(ad, torch.from_numpy(ai).to(dev))
    z2 = Split(bd, torch.from_numpy(bi).to(dev))
    want = np.stack([np.convolve(a[i] + 1j * ai[i].astype(np.float64),
                                 b[i] + 1j * bi[i].astype(np.float64))
                     for i in range(CHANNELS)])

    def complex_call():
        got = sp.convolve_complex(z1, z2)
        return torch.cat([got.re, got.im], dim=-1)

    run("small-convolve-complex", ("fft_tiny",), complex_call,
        np.concatenate([want.real, want.imag], axis=-1))
    if launches.by_path["small-convolve-complex"]["fft_tiny"] != 3:
        fail("small-convolve-complex: K12's tiny form did not launch three times")
    x = rng.standard_normal((CHANNELS, FS)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    w = _hann64(16)

    def roundtrip():
        spec = stft_mod.stft(xd, w, 16, 8, boundary=True)
        return stft_mod.istft(spec, w, 8, length=FS, boundary=True)

    run("small-stft-roundtrip", ("rfft_tiny_windowed", "rifft_tiny_windowed"), roundtrip,
        x.astype(np.float64))
    torch.cuda.empty_cache()


LARGE_RATE = 96000  # the deconvolved capture's sample rate (phase 23)


def large_kernels(randn, mods, smi, results, real_lms=range(21, 29),
                  complex_lms=range(20, 29)) -> None:
    """Phase 22: the sizes above real 2^20 / complex 2^19 (the long routes of
    ``csrc/fft_large.cuh``): K13 and K14 at real N = 2^21..2^28, K12 forward
    and inverse at complex N = 2^20..2^28, each at the batch that moves at
    least 1 GiB in and out (one frame where a frame moves more), against its
    plain version (>= 110 dB; ``compare``, with its times and bound), with
    the peak memory of one call and the device ms of each pass
    (``torch.profiler``; a pass that runs the same kernel twice counts
    once); added to the kernels' entries as ``sizes``."""
    hf = mods["hopper_fft"]
    cases = ([("rfft_packed_split", lm, None) for lm in real_lms]
             + [("rifft_packed_split", lm, None) for lm in real_lms]
             + [("fft_split", lm, inv) for lm in complex_lms for inv in (False, True)])
    for name, lm, inverse in cases:
        n = 1 << lm
        moved = (16 if name == "fft_split" else 8) * n  # bytes in and out a frame
        b = max(1, (1 << 30) // moved)
        k = n // 2 if name == "rifft_packed_split" else n
        args = (randn(b, k),) if name == "rfft_packed_split" else (randn(b, k), randn(b, k))
        kw = {} if inverse is None else dict(inverse=inverse)
        fn = getattr(hf, name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(*args, **kw)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        torch.cuda.empty_cache()
        label = f"{name} ({b}, 2^{lm}){' inverse' if inverse else ''}"
        print(f"{label}: peak memory of the call {peak:.2f} GiB [{smi}]", flush=True)
        entry = compare(name, fn, getattr(hf, name + "_plain"), args, kw, True, smi)
        entry.update(n=n, peak_gib=peak,
                     passes_ms=phase_ms(lambda: fn(*args, **kw), smi, label, runs=3))
        results[name].setdefault("sizes", []).append(entry)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], entry["max_abs_err"])
        results[name]["snr_db"] = min(results[name]["snr_db"], entry["snr_db"])
        del args
        torch.cuda.empty_cache()


def large_paths(dev, irs, launches, smi) -> None:
    """Phase 23: the public calls at those sizes, at full width: (a)
    ``spectral_processor.convolve`` of 128 channels of 20 s signals (960 000
    samples, seed 0) with the 10 s IRs, a linear size of 1 439 999, N = 2^21
    (K13 twice, K14 once); (b) ``pipeline.ir_deconvolve`` of a 30 s capture
    at 96 kHz (a 25 s log sweep through the same IRs, read as 5 s at 96 kHz,
    and its tail), N = 2^22 (K13 twice, K14 once). Each against a float64
    numpy mirror of channel 0 (>= 99 dB), with ms per call and peak
    memory."""
    from hisstools_library_tpu_torch.models import pipeline
    from hisstools_library_tpu_torch.ops import spectral_processor as sp

    k13k14 = ("rfft_packed_split", "rifft_packed_split")
    ird = torch.from_numpy(irs).to(dev)
    rng = np.random.default_rng(0)
    rng.standard_normal((CHANNELS, IR_LEN))  # the IRs' draw, as main() makes it
    x20 = rng.standard_normal((CHANNELS, 20 * FS)).astype(np.float32)
    sig = torch.from_numpy(x20).to(dev)
    n_lin = 20 * FS + IR_LEN - 1
    path_run("large-convolve-2^21", lambda: sp.convolve(sig, ird), k13k14,
             convolve_f64(x20[0], irs[0], n_lin), launches, smi)
    for k, want in zip(k13k14, (2, 1)):
        if launches.by_path["large-convolve-2^21"][k] != want:
            fail(f"large-convolve-2^21: {k} did not launch {want} times")
    del sig, x20
    capture, sweep32, ref = sweep_capture(dev, ird, LARGE_RATE, 25 * LARGE_RATE,
                                          30 * LARGE_RATE)
    path_run("large-ir-deconvolve-2^22", lambda: pipeline.ir_deconvolve(capture, sweep32),
             k13k14, ref, launches, smi)
    for k, want in zip(k13k14, (2, 1)):
        if launches.by_path["large-ir-deconvolve-2^22"][k] != want:
            fail(f"large-ir-deconvolve-2^22: {k} did not launch {want} times")
    del capture, sweep32, ird
    torch.cuda.empty_cache()


GRAD_SEED = 0x1557  # the autograd tests' seed (tests/conftest.py's rng)


def _grad_cases():
    """The six cases of tests/test_torch_autograd.py, inputs drawn from the
    tests' seed in their order: name -> f(device) returning the gradient (a
    host array) of the case's loss."""
    from hisstools_library_tpu_torch.core.types import Split
    from hisstools_library_tpu_torch.models import mono, time_domain
    from hisstools_library_tpu_torch.ops import spectral_processor as sp

    scheme = mono.PartitionScheme((32, 128), zero_latency=True)

    def leaf(a, dev):
        return torch.tensor(a, device=dev, requires_grad=True)

    def scheme_input(dev, batch=()):
        rng = np.random.default_rng(GRAD_SEED)
        ir = rng.standard_normal(300 if batch else 500).astype(np.float32)
        x = leaf(rng.standard_normal(batch + (512,)).astype(np.float32), dev)
        mir = mono.prepare_ir(scheme, ir, offline_tail=False, device=dev)
        _, y = mono.process(mir, mono.init_state(scheme, mir, batch), x)
        torch.sum(y * y).backward()
        return x.grad.cpu().numpy()

    def ir_spectra(dev):
        rng = np.random.default_rng(GRAD_SEED)
        ir = (rng.standard_normal(200) * 0.1).astype(np.float32)
        target = (rng.standard_normal(200) * 0.1).astype(np.float32)
        target[:scheme.head_taps] = ir[:scheme.head_taps]
        x = torch.from_numpy(rng.standard_normal(512).astype(np.float32)).to(dev)
        mir = mono.prepare_ir(scheme, ir, offline_tail=False, device=dev)
        st = mono.init_state(scheme, mir, ())
        _, y_target = mono.process(mono.prepare_ir(scheme, target, offline_tail=False,
                                                   device=dev), st, x)
        ps = [p.clone().requires_grad_(True) for s in mir.spectra for p in (s.re, s.im)]
        spectra = tuple(Split(ps[2 * k], ps[2 * k + 1]) for k in range(len(ps) // 2))
        _, y = mono.process(mono.MonoIR(mir.head_taps, spectra, None, 0), st, x)
        torch.mean((y - y_target) ** 2).backward()
        return np.concatenate([p.grad.cpu().numpy().ravel() for p in ps])

    def taps(dev):
        rng = np.random.default_rng(GRAD_SEED)
        x = torch.from_numpy(rng.standard_normal(300).astype(np.float32)).to(dev)
        h = leaf(rng.standard_normal(16).astype(np.float32), dev)
        torch.sum(time_domain.fir_offline(x, h) ** 2).backward()
        return h.grad.cpu().numpy()

    def convolve(dev):
        rng = np.random.default_rng(GRAD_SEED)
        x = leaf(rng.standard_normal(256).astype(np.float32), dev)
        h = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(dev)
        torch.sum(sp.convolve(x, h, sp.EdgeMode.Linear) ** 2).backward()
        return x.grad.cpu().numpy()

    def change_phase(dev):
        rng = np.random.default_rng(GRAD_SEED)
        x = leaf((rng.standard_normal(256) * np.exp(-np.arange(256) / 40.0))
                 .astype(np.float32), dev)
        torch.sum(sp.change_phase(x, 0.0) ** 2).backward()
        return x.grad.cpu().numpy()

    return {"scheme-input": scheme_input, "ir-spectra-first-step": ir_spectra,
            "fir-taps": taps, "spectral-convolve": convolve,
            "change-phase-0": change_phase,
            "batched-4x512": lambda dev: scheme_input(dev, (4,))}


def _raised_kernel(err) -> str:
    """The kernel a no-backward error names (its message starts "K.. name:")."""
    head = str(err).split(":")[0]
    name = head.split(" ")[-1]
    if not head.startswith("K") or name not in KERNELS:
        fail(f"gradient error names no hand kernel: {err}")
    return head


def gradient_paths(dev, irs, x, smi) -> None:
    """Phase 24: the autograd tests' six cases on the card. Each either
    gives the CPU run's gradient (>= 110 dB) or raises the no-backward error
    naming a hand kernel (``_build.NoBackwardError``: the kernels have no
    backward, and a launch would return an output cut off from autograd);
    a gradient that differs fails the run. Then ``mono.process`` at the
    stream shape (Zero preset, 128 channels, the 10 s IRs, one two-tier call
    of 131 072 samples) with an input that requires grad must raise."""
    from hisstools_library_tpu_torch import _build
    from hisstools_library_tpu_torch.models import mono

    outcomes = {}
    for name, case in _grad_cases().items():
        want = case(torch.device("cpu"))
        try:
            got = case(dev)
        except _build.NoBackwardError as err:
            outcomes[name] = f"raised ({_raised_kernel(err)})"
            continue
        snr = snr_db(torch.from_numpy(want), torch.from_numpy(got))
        if not (snr >= SNR_MIN_KERNEL_DB and np.isfinite(got).all()):
            fail(f"gradient {name}: the card's gradient is {snr:.2f} dB from the CPU's")
        outcomes[name] = f"gradient, {snr:.2f} dB vs the CPU's"
    for name, what in outcomes.items():
        print(f"gradient {name}: {what} [{smi}]", flush=True)

    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    ir = mono.prepare_ir(zero, irs, offline_tail=False, device=dev)
    state = mono.init_block_state(zero, ir, batch_shape=(CHANNELS,))
    xg = torch.from_numpy(np.ascontiguousarray(x[:, :STREAM_BLOCK])).to(dev).requires_grad_()
    try:
        mono.process(ir, state, xg)
    except _build.NoBackwardError as err:
        print(f"gradient stream-shape mono.process ({CHANNELS} x {STREAM_BLOCK}, two-tier): "
              f"raised ({_raised_kernel(err)}) [{smi}]", flush=True)
    else:
        fail("mono.process at the stream shape returned with an input that requires "
             "grad: its hand kernels' part of the gradient would be missing")
    del ir, state, xg
    torch.cuda.empty_cache()


def parallel_paths(dev, irs, x, launches, smi, results) -> None:
    """Phase 25: ``parallel`` at world size 1 over NCCL (the process group
    made here and destroyed at the end), at full width. (a)
    ``scheme_offline_sharded`` of the Zero scheme (prepare_ir without the
    tail) on the 128 x 483 328 signal: the 4096 and 16384 sections as K2 ->
    K15 (lead_skip 1) -> K4 (each must launch; K5 must not), channel 0 >=
    99 dB against float64, the whole output >= 110 dB against
    ``process_offline``; ms/pass, peak memory, K15's shapes there and K15
    against its plain version at the largest; (b) ``n_to_one_offline``
    against (a)'s channel sum in float64 (>= 110 dB); (c)
    ``scheme_stream_sharded`` on the two-tier Zero stream, two calls of
    131 072 samples, bit-equal to ``mono.process``; (d)
    ``scheme_stream_any_sharded``, 128 callbacks of 256 samples, bit-equal
    to ``process_any``; (e) ``fft_sharded`` (complex 2^17), ``rfft_sharded``
    / ``rifft_sharded`` (real 2^17) and ``convolve_sharded`` (channel 0's
    signal and IR, N = 2^20) against their single-card counterparts."""
    import torch.distributed as dist

    from hisstools_library_tpu_torch import parallel
    from hisstools_library_tpu_torch.fft import api as fft_api
    from hisstools_library_tpu_torch.fft import hopper_kernels
    from hisstools_library_tpu_torch.models import mono
    from hisstools_library_tpu_torch.ops import spectral_processor as sp

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = parallel.make_mesh()
    print(f"parallel: process group {dist.get_backend()}, world size "
          f"{dist.get_world_size()}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}; "
          f"collectives across cards are unverified on a one-card host [{smi}]", flush=True)
    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    xd = torch.from_numpy(x).to(dev)
    ir = mono.prepare_ir(zero, irs, offline_tail=False, device=dev)

    # (a) The sharded offline scheme; K15's calls recorded by a wrapper.
    k15_calls = []
    k15 = hopper_kernels.lag_mac

    def recording(*args, **kwargs):
        k15_calls.append((args, kwargs))
        return k15(*args, **kwargs)

    recording.launches = 0  # K15 counts its launches on its module name
    hopper_kernels.lag_mac = recording
    launches.reset()
    torch.cuda.reset_peak_memory_stats()
    y = parallel.scheme_offline_sharded(mesh, zero, ir, xd)
    torch.cuda.synchronize()
    hopper_kernels.lag_mac = k15
    k15.launches += recording.launches
    launches.read("parallel-offline", ("rfft_packed_stream", "lag_mac", "rifft_packed_tail"),
                  smi, forbid=("fastfir_chain",))
    peak = torch.cuda.max_memory_allocated() / 2**30
    y = y.full_tensor()
    if tuple(y.shape) != (CHANNELS, SIG_LEN):
        fail(f"parallel-offline: output shape {tuple(y.shape)}")
    check_path_snr("parallel-offline", y[0], x[0], irs[0], smi)
    ref = mono.process_offline(ir, xd)
    snr = snr_db(ref, y)
    ms = median_ms(lambda: parallel.scheme_offline_sharded(mesh, zero, ir, xd), runs=3)
    shapes = [(tuple(a[0].shape), tuple(a[2].shape), a[4], kw) for a, kw in k15_calls]
    print(f"parallel-offline: SNR vs process_offline (no tail, all channels) {snr:.2f} dB; "
          f"{ms:.4f} ms/pass (CUDA events, median of 3 after a warm-up), "
          f"{CHANNELS * SIG_LEN / (ms * 1e-3):.6e} samples/s; peak memory {peak:.2f} GiB; "
          f"K15 at (X, H, T, opts) {shapes} [{smi}]", flush=True)
    if not snr >= SNR_MIN_KERNEL_DB:
        fail(f"parallel-offline: SNR vs process_offline {snr:.2f} dB < {SNR_MIN_KERNEL_DB}")
    args, kwargs = max(k15_calls, key=lambda c: c[0][0].numel())
    del k15_calls, ref
    entry = compare("lag_mac", k15, hopper_kernels.lag_mac_plain, args, kwargs, True, smi)
    entry["path"] = "parallel-offline"
    results["lag_mac"]["shapes"].append(entry)
    del args, kwargs

    # (b) N-to-mono against (a)'s channel sum.
    launches.reset()
    y1 = parallel.n_to_one_offline(mesh, zero, ir, xd)
    torch.cuda.synchronize()
    launches.read("parallel-n-to-one", ("rfft_packed_stream", "lag_mac",
                                        "rifft_packed_tail"), smi, forbid=("fastfir_chain",))
    snr = snr_db(y.double().sum(0), y1.full_tensor())
    print(f"parallel-n-to-one: SNR vs the channel sum of parallel-offline (float64) "
          f"{snr:.2f} dB [{smi}]", flush=True)
    if not snr >= SNR_MIN_KERNEL_DB:
        fail(f"parallel-n-to-one: SNR {snr:.2f} dB < {SNR_MIN_KERNEL_DB}")
    del y, y1, xd
    torch.cuda.empty_cache()

    # (c) Channel-parallel two-tier streaming, the state carried as DTensors.
    blocks = [torch.from_numpy(np.ascontiguousarray(x[:, i * STREAM_BLOCK:(i + 1) *
                                                      STREAM_BLOCK])).to(dev)
              for i in range(2)]
    launches.reset()
    st = mono.init_block_state(zero, ir, batch_shape=(CHANNELS,))
    got = []
    for blk in blocks:
        st, yb = parallel.scheme_stream_sharded(mesh, ir, st, blk)
        got.append(yb.full_tensor())
    torch.cuda.synchronize()
    launches.read("parallel-stream", ("fastfir_chain_stream",), smi,
                  ("lag_mac_ring", "rifft_packed_tail"))
    ref = mono.init_block_state(zero, ir, batch_shape=(CHANNELS,))
    for i, blk in enumerate(blocks):
        ref, yr = mono.process(ir, ref, blk)
        if not torch.equal(got[i], yr):
            fail(f"parallel-stream call {i}: not bit-equal to mono.process")
    print(f"parallel-stream: two two-tier calls of {STREAM_BLOCK} samples bit-equal to "
          f"mono.process [{smi}]", flush=True)
    del blocks, got, st, ref

    # (d) Sample-granular streaming, 128 callbacks.
    xa = torch.from_numpy(np.ascontiguousarray(x[:, :CALLS * CALLBACK])).to(dev)
    launches.reset()
    st = mono.init_stream_state(zero, ir, batch_shape=(CHANNELS,))
    got = []
    for i in range(CALLS):
        st, ya = parallel.scheme_stream_any_sharded(
            mesh, ir, st, xa[:, i * CALLBACK:(i + 1) * CALLBACK].contiguous())
        got.append(ya.full_tensor())
    torch.cuda.synchronize()
    launches.read("parallel-stream-any", ("hop_fire", "rifft_packed", "rfft_packed"), smi)
    ref = mono.init_stream_state(zero, ir, batch_shape=(CHANNELS,))
    for i in range(CALLS):
        ref, yr = mono.process_any(ir, ref, xa[:, i * CALLBACK:(i + 1) * CALLBACK].contiguous())
        if not torch.equal(got[i], yr):
            fail(f"parallel-stream-any callback {i}: not bit-equal to process_any")
    print(f"parallel-stream-any: {CALLS} callbacks of {CALLBACK} samples bit-equal to "
          f"process_any [{smi}]", flush=True)
    del xa, got, st, ref, ir
    torch.cuda.empty_cache()

    # (e) The sharded transforms against their single-card counterparts.
    gen = torch.Generator(device=dev).manual_seed(25)
    zr, zi = (torch.randn(1 << 17, generator=gen, device=dev) for _ in range(2))
    xr = torch.randn(1 << 17, generator=gen, device=dev)
    sig = torch.from_numpy(x[0]).to(dev)
    h0 = torch.from_numpy(irs[0]).to(dev)
    launches.reset()
    fr, fi = parallel.fft_sharded(mesh, zr, zi)
    pr, pi = parallel.rfft_sharded(mesh, xr)
    back = parallel.rifft_sharded(mesh, pr, pi)
    yc = parallel.convolve_sharded(mesh, sig, h0)
    torch.cuda.synchronize()
    launches.read("parallel-fft", ("fft_split", "rfft_packed", "rifft_packed",
                                   "rfft_packed_split", "rifft_packed_split"), smi)
    pairs = {"fft_sharded vs fft.api.fft": (fft_api.fft(zr, zi), (fr, fi)),
             "rfft_sharded vs fft.api.rfft": (fft_api.rfft(xr), (pr, pi)),
             "rifft_sharded vs fft.api.rifft": ((fft_api.rifft(pr.to_local(), pi.to_local()),),
                                                (back,)),
             "convolve_sharded vs spectral_processor.convolve": ((sp.convolve(sig, h0),), (yc,))}
    for label, (want, got) in pairs.items():
        snr = min(snr_db(w, g.full_tensor()) for w, g in zip(want, got))
        print(f"parallel-fft: {label}: SNR {snr:.2f} dB [{smi}]", flush=True)
        if not snr >= SNR_MIN_KERNEL_DB:
            fail(f"parallel-fft: {label} SNR {snr:.2f} dB < {SNR_MIN_KERNEL_DB}")
    n = SIG_LEN + IR_LEN - 1
    check_path_snr("parallel-convolve", yc.full_tensor(), x[0], irs[0], smi)
    if tuple(yc.shape) != (n,):
        fail(f"parallel-convolve: shape {tuple(yc.shape)}, expected ({n},)")
    dist.destroy_process_group()
    del zr, zi, xr, sig, h0, fr, fi, pr, pi, back, yc
    torch.cuda.empty_cache()


def df64_paths(dev, smi) -> None:
    """Phase 26: the double-float FFT on the card (no hand kernel: element-wise
    torch ops, one rounding each, the JAX package's float32 sequence)."""
    from hisstools_library_tpu_torch.fft import df64

    err = df64.selfcheck(device=dev)
    print(f"df64: selfcheck {err:.3e} (< 1e-10: the compensation survived) [{smi}]",
          flush=True)
    if not err < 1e-10:
        fail(f"df64: selfcheck {err:.3e} >= 1e-10")
    n = 1 << 16
    gen = torch.Generator(device=dev).manual_seed(26)
    x, re, im = (torch.randn(CHANNELS, n, generator=gen, device=dev) for _ in range(3))
    zero = torch.zeros_like(x)

    def run(label, call, want, got_of):
        got = got_of(call())
        torch.cuda.synchronize()
        snr = min(snr_db(torch.from_numpy(w), torch.from_numpy(g)) for w, g in zip(want, got))
        ms = median_ms(call, runs=3)
        print(f"df64 {label} ({CHANNELS} x 2^16): SNR vs float64 {snr:.2f} dB, {ms:.3f} ms/call "
              f"(CUDA events, median of 3 after a warm-up) [{smi}]", flush=True)
        if not snr >= SNR_MIN_DF64_DB:
            fail(f"df64 {label}: SNR {snr:.2f} dB < {SNR_MIN_DF64_DB}")

    x64 = x.double().cpu().numpy()
    run("rifft(rfft(x)) == 2N x", lambda: df64.rifft_df64(*df64.rfft_df64(x)),
        (2.0 * n * x64,), lambda y: (df64.dd_to_f64(*y),))
    z = re.double().cpu().numpy() + 1j * im.double().cpu().numpy()
    fwd = np.fft.fft(z, axis=-1)
    run("fft_df64 forward", lambda: df64.fft_df64(re, zero, im, zero),
        (fwd.real, fwd.imag),
        lambda y: (df64.dd_to_f64(y[0], y[1]), df64.dd_to_f64(y[2], y[3])))
    run("fft_df64 inverse (unscaled)", lambda: df64.fft_df64(re, zero, im, zero, inverse=True),
        ((n * np.fft.ifft(z, axis=-1)).real, (n * np.fft.ifft(z, axis=-1)).imag),
        lambda y: (df64.dd_to_f64(y[0], y[1]), df64.dd_to_f64(y[2], y[3])))
    del x, re, im, zero
    torch.cuda.empty_cache()


def _tool_lines(tool, argv) -> tuple:
    """Run a tool's ``main`` in this process; its return value and what it
    printed (to standard output and error), echoed here line by line."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool.main(argv)
    text = out.getvalue() + err.getvalue()
    for line in text.splitlines():
        print(f"  | {line}", flush=True)
    return rc, text


def cli_paths(dev, irs, x, launches, smi) -> None:
    """Phase 27: the convolve_wav tool at full width, in process."""
    import re
    import tempfile

    from hisstools_library_tpu_torch.io import FileType, IAudioFile, OAudioFile, PCMFormat
    from hisstools_library_tpu_torch.tools import convolve_wav

    n_out = SIG_LEN + IR_LEN - 1
    ref0 = convolve_f64(x[0], irs[0], n_out)
    with tempfile.TemporaryDirectory() as tmp:
        sig, ir_p = os.path.join(tmp, "signal.wav"), os.path.join(tmp, "ir.wav")
        t0 = time.perf_counter()
        for path, data in ((sig, x), (ir_p, irs)):
            with OAudioFile(path, FileType.WAVE, PCMFormat.Float32, CHANNELS, float(FS)) as f:
                f.write_interleaved(data.T)
                if f.get_is_error():
                    fail(f"cli: writing {path} failed: {f.get_errors()}")
        print(f"cli: wrote the {CHANNELS} x {SIG_LEN} signal and the {CHANNELS} x {IR_LEN} IRs "
              f"as float32 "
              f"WAVs in {time.perf_counter() - t0:.2f} s [{smi}]", flush=True)
        for label, flags, need, forbid in (
                ("cli-fast", ["--engine", "fast"], ("rfft_packed", "fastfir_chain"), STAGED),
                ("cli-scheme", ["--engine", "scheme"], ("rfft_packed", "fastfir_chain"), ()),
                ("cli-stream", ["--stream"], ("rfft_packed", "fastfir_chain_stream",
                                              "rfft_small"),
                 ("lag_mac_ring", "rifft_packed_tail"))):
            out = os.path.join(tmp, label + ".wav")
            launches.reset()
            t0 = time.perf_counter()
            rc, text = _tool_lines(convolve_wav, [sig, ir_p, out, *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches.read(label, need, smi, forbid)
            if rc != 0:
                fail(f"{label}: convolve_wav returned {rc}")
            with IAudioFile(out) as f:
                if f.get_is_error() or f.frames != n_out or f.channels != CHANNELS:
                    fail(f"{label}: output {f.channels} x {f.frames}, errors {f.get_errors()}")
                yall = f.read_interleaved(dtype=np.float32)  # (frames, channels)
            y0 = yall[:, 0].astype(np.float64)
            peak_at = None
            if "--stream" not in flags:
                # The tool scales its output to -1 dBFS by its peak: find the
                # sample and channel of the file's peak, and scale the
                # reference by the float64 convolution there.
                peak_at = np.unravel_index(int(np.argmax(np.abs(yall))), yall.shape)
            del yall
            if not np.isfinite(y0).all():
                fail(f"{label}: non-finite output")
            scale = 1.0
            if peak_at is not None:
                n_pk, c_pk = peak_at
                peak = abs(convolve_f64(x[c_pk], irs[c_pk], n_pk + 1)[n_pk])
                scale = 10 ** (-1 / 20) / peak
            snr = snr_db(torch.from_numpy(ref0 * scale), torch.from_numpy(y0))
            times = "; ".join(f"{m.group(1)} {m.group(2)}" for m in re.finditer(
                r"^(read|convolved|streamed|wrote) .*? in ([0-9.]+ ?m?s)", text, re.M))
            print(f"{label}: channel 0 of the output WAV ({n_out} frames) vs float64 FFT "
                  f"convolution{' x the tool scale' if peak_at else ''}: {snr:.2f} dB; "
                  f"tool wall {wall:.3f} s ({times}) [{smi}]", flush=True)
            if not snr >= SNR_MIN_CLI_DB:
                fail(f"{label}: SNR {snr:.2f} dB < {SNR_MIN_CLI_DB}")
            os.remove(out)
    torch.cuda.empty_cache()


def serve_demo_paths(launches, smi) -> None:
    """Phase 28: the serve_demo tool at 128 channels, both hosts."""
    from hisstools_library_tpu_torch.tools import serve_demo

    for label, extra in (("serve-demo", []), ("serve-demo-native", ["--native-host"])):
        launches.reset()
        rc, _ = _tool_lines(serve_demo, ["--channels", str(CHANNELS), "--seconds", "2",
                                         "--swaps", "2", *extra])
        torch.cuda.synchronize()
        launches.read(label, ("hop_fire", "rfft_packed", "rifft_packed"), smi)
        print(f"{label}: serve_demo returned {rc} [{smi}]", flush=True)
        if rc != 0:
            fail(f"{label}: serve_demo returned {rc}")
    torch.cuda.empty_cache()


def fuzz_paths(launches, smi) -> None:
    """Phase 29: the fuzz_oracle tool on the card for half a minute."""
    import re

    from hisstools_library_tpu_torch.tools import fuzz_oracle

    launches.reset()
    t0 = time.perf_counter()
    rc, text = _tool_lines(fuzz_oracle, ["--minutes", "0.5", "--seed", "0"])
    torch.cuda.synchronize()
    launches.read("fuzz", (), smi)
    m = re.search(r"(\d+) cases, (\d+) failures", text)
    print(f"fuzz: returned {rc}, {m.group(1) if m else '?'} draws, "
          f"{m.group(2) if m else '?'} failures in {time.perf_counter() - t0:.1f} s [{smi}]",
          flush=True)
    if rc != 0:
        fail(f"fuzz: fuzz_oracle returned {rc}")
    torch.cuda.empty_cache()


def _dirty_allocator(nbytes: int) -> None:
    """Hand the caching allocator's free lists back full of NaN: one large
    block of ``nbytes`` and 64 small-pool blocks of 1 MiB, filled and freed,
    after the cache is emptied, so the next allocations are carved from
    them."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    big = torch.full((max(nbytes, 1 << 30) // 4,), float("nan"), device="cuda")
    small = [torch.full(((1 << 20) // 4,), float("nan"), device="cuda") for _ in range(64)]
    torch.cuda.synchronize()
    del big, small


def _outputs(got) -> list:
    return list(got) if isinstance(got, tuple) else [got]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def determinism_kernels(mods, path_cases, smi) -> None:
    """Phase 30a: each kernel twice on the same inputs at its first path
    shape, a NaN-dirtied allocator before the second launch."""
    for name in KERNELS:
        fn = getattr(mods[KERNELS[name][0]], name)
        args, kwargs = path_cases[name]()
        tensors = [a for a in list(args) + list(kwargs.values()) if isinstance(a, torch.Tensor)]
        before = [t.clone() for t in tensors]
        first = _outputs(fn(*args, **kwargs))
        torch.cuda.synchronize()
        if not all(_same_bits(t, b) for t, b in zip(tensors, before)):
            fail(f"determinism: {name} changed its inputs")
        _dirty_allocator(4 * sum(t.numel() * t.element_size() for t in first))
        second = _outputs(fn(*args, **kwargs))
        torch.cuda.synchronize()
        shapes = [tuple(t.shape) for t in tensors]
        if not all(_same_bits(a, b) for a, b in zip(first, second)):
            bad = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                      for a, b in zip(first, second))
            fail(f"determinism: {name} at {shapes}: {bad} output elements differ between "
                 "two launches on the same inputs")
        print(f"determinism: {name} at {shapes}: two launches bit-equal "
              f"(the second into NaN-filled blocks) [{smi}]", flush=True)
        del args, kwargs, tensors, before, first, second
        torch.cuda.empty_cache()


def determinism_paths(dev, irs, x, launches, smi) -> None:
    """Phase 30b-c: whole paths twice from fresh states, bit-equal, and the
    long stream's accuracy at its first and last calls."""
    from hisstools_library_tpu_torch.models import mono
    from hisstools_library_tpu_torch.models.offline import FastFIR

    zero = mono.PartitionScheme.from_latency(mono.LatencyMode.Zero)
    launches.reset()
    xd = torch.from_numpy(x).to(dev)
    eng = FastFIR(irs, device=dev)
    ir = mono.prepare_ir(zero, irs, offline_tail=False, device=dev)

    def fastfir():
        return [FastFIR.apply(eng.spectra, xd)]

    def callbacks_128():
        st = mono.init_stream_state(zero, ir, batch_shape=(CHANNELS,))
        ys = []
        for i in range(CALLS):
            st, y = mono.process_any(ir, st, xd[:, i * CALLBACK:(i + 1) * CALLBACK].contiguous())
            ys.append(y)
        return ys

    def two_tier():
        st = mono.init_block_state(zero, ir, batch_shape=(CHANNELS,))
        ys = []
        for i in range(2):
            st, y = mono.process(ir, st, xd[:, i * STREAM_BLOCK:(i + 1) * STREAM_BLOCK]
                                 .contiguous())
            ys.append(y)
        return ys

    for label, run in (("FastFIR pass", fastfir), (f"{CALLS} process_any callbacks", callbacks_128),
                       ("two two-tier mono.process calls", two_tier)):
        first = run()
        torch.cuda.synchronize()
        _dirty_allocator(4 * sum(t.numel() * t.element_size() for t in first))
        second = run()
        torch.cuda.synchronize()
        if not all(_same_bits(a, b) for a, b in zip(first, second)):
            fail(f"determinism: {label}: two runs from fresh states differ")
        print(f"determinism: {label}, twice from fresh states: bit-equal [{smi}]", flush=True)
        del first, second
    del eng, xd
    torch.cuda.empty_cache()

    # The long stream: 64 two-tier calls, each block drawn on the card.
    calls = 64
    gen = torch.Generator(device=dev).manual_seed(30)
    st = mono.init_block_state(zero, ir, batch_shape=(CHANNELS,))
    x0, y0 = [], {}
    t0 = time.perf_counter()
    for j in range(calls):
        blk = torch.randn(CHANNELS, STREAM_BLOCK, generator=gen, device=dev)
        st, y = mono.process(ir, st, blk)
        x0.append(blk[0].cpu().numpy())
        if j in (0, calls - 1):
            y0[j] = y[0].cpu()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.read("determinism", ("fastfir_chain", "hop_fire", "rifft_packed",
                                  "fastfir_chain_stream"), smi)
    n = calls * STREAM_BLOCK
    ref = convolve_f64(np.concatenate(x0), irs[0], n)
    snrs = {j: snr_db(torch.from_numpy(ref[j * STREAM_BLOCK:(j + 1) * STREAM_BLOCK]), y)
            for j, y in y0.items()}
    first, last = snrs[0], snrs[calls - 1]
    print(f"drift: {calls} two-tier calls of {STREAM_BLOCK} samples x {CHANNELS} channels, "
          f"the 10 s IRs ({wall:.2f} s with the host copies): channel 0 vs float64 FFT "
          f"convolution, call 0 {first:.2f} dB, call {calls - 1} {last:.2f} dB [{smi}]",
          flush=True)
    if not (first >= SNR_MIN_CLI_DB and last >= SNR_MIN_CLI_DB and abs(first - last) < 15.0):
        fail(f"drift: first {first:.2f} / last {last:.2f} dB (>= {SNR_MIN_CLI_DB} each and "
             "within 15 dB)")
    del st, ir
    torch.cuda.empty_cache()


def main() -> None:
    profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "hisstools_library_tpu_torch", "csrc")):
        fail(f"no hisstools_library_tpu_torch/csrc beside {__file__}: run it "
             "from a checkout of the repository")
    sys.path.insert(0, root)
    from hisstools_library_tpu_torch import _build
    from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels

    mods = {"hopper_fft": hopper_fft, "hopper_kernels": hopper_kernels}
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} (count "
          f"{torch.cuda.device_count()}); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    print(smi, flush=True)  # the card as nvidia-smi names it: "name, power limit"

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path()} [{smi}]",
          flush=True)
    log = _build.library_path().with_suffix(".log")
    if log.exists():  # written by this run's build: one line per kernel
        entry = "?"
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and "registers" in line:
                print(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}")
            elif "spill" in line and not line.strip().startswith("0 bytes stack"):
                print(f"  ptxas {entry}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    results = fastfir_kernels(randn, mods, smi)
    # Main paths, built from seed 0 as bench.py builds them.
    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((CHANNELS, IR_LEN)) *
           np.exp(-np.arange(IR_LEN) / (0.5 * FS))).astype(np.float32)
    x = rng.standard_normal((CHANNELS, SIG_LEN)).astype(np.float32)
    # The serving phase's second bank, the next draws of the same generator.
    irs2 = (rng.standard_normal((CHANNELS, IR_LEN)) *
            np.exp(-np.arange(IR_LEN) / (0.5 * FS))).astype(np.float32)
    launches = Launches(mods)
    fastfir_path(dev, irs, x, launches, smi)
    results.update(stream_kernels(randn, mods, smi))
    results.update(stream_matrix_kernel(randn, mods, smi))
    stream_paths(dev, irs, x, launches, smi, profile)
    time_domain_check(dev, smi)
    results.update(slice_kernels(randn, mods, smi))
    one_pass_inverses(randn, mods, smi)
    subhop_paths(dev, irs, x, launches, smi, profile)
    serving_paths(dev, irs, irs2, x, launches, smi)
    del irs2
    stage_report_paths(dev, irs, x, launches, smi)
    offline_paths(dev, irs, x, launches, smi)
    results.update(spectral_kernels(randn, mods, smi))
    results.update(bin_kernels(randn, mods, smi))
    spectral_paths(dev, irs, x, launches, smi)
    results.update(windowed_kernels(randn, mods, smi))
    stft_path(dev, launches, smi, profile)
    pipeline_paths(dev, launches, smi, profile)
    convolver_paths(dev, irs, x, launches, smi)
    results.update(tiny_kernels(randn, mods, smi))
    tiny_paths(dev, launches, smi)
    large_kernels(randn, mods, smi, results)
    large_paths(dev, irs, launches, smi)
    gradient_paths(dev, irs, x, smi)
    parallel_paths(dev, irs, x, launches, smi, results)
    path_cases = {name: results[name].pop("path_case") for name in KERNELS}
    df64_paths(dev, smi)
    cli_paths(dev, irs, x, launches, smi)
    serve_demo_paths(launches, smi)
    fuzz_paths(launches, smi)
    determinism_kernels(mods, path_cases, smi)
    determinism_paths(dev, irs, x, launches, smi)

    for name in KERNELS:
        by_path = {p: c[name] for p, c in launches.by_path.items()}
        if not sum(by_path.values()):
            fail(f"kernel {name} was launched on no path")
        results[name]["launches_by_path"] = by_path
        results[name]["launches"] = sum(by_path.values())
    print(json.dumps({"kernels": [results[k] for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
