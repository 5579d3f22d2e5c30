"""Command-line tools of the port, twins of the JAX repository's ``tools/``
scripts of the same names and flags:

- :mod:`.convolve_wav`  convolve an audio file with an impulse response
- :mod:`.serve_demo`    real-time serving with IR hot-swap under a stream
- :mod:`.fuzz_oracle`   randomized engines against float64 convolution

Each runs on the CUDA card unless given ``--cpu``:

    python -m hisstools_library_tpu_torch.tools.convolve_wav in.wav ir.wav out.wav
"""
