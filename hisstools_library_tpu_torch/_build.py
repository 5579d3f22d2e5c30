"""Builds and loads the port's Hopper kernels (``csrc/*.cu``).

Each ``.cu`` file is compiled with ``nvcc`` for ``sm_90a`` in its own
process, all started together, and the objects are linked into one shared
library with a plain C interface, under ``build/hisstools_torch_kernels/`` next
to the package, named by a hash of the sources and flags, so an edit to any
source gives a new build. The library is built at first use (never at import)
and loaded with ``ctypes``. Every C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; :func:`check` raises when that is not
0. Nothing prebuilt is used: the sources in ``csrc/`` are the only input.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "hisstools_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# Pointer arguments and the stream are c_void_p: without argtypes ctypes would
# pass them as 32-bit ints and cut them.
_SIGNATURES = {
    # x, re, im, tw, batch, n, stream
    "hst_rfft_packed": [_P, _P, _P, _P, _L, _I, _P],
    # n -> frames K1 holds on the card at once (or minus a CUDA error)
    "hst_rfft_packed_resident": [_I],
    # x, re, im, tw, channels, hops, n, stream
    "hst_rfft_packed_stream": [_P, _P, _P, _P, _L, _I, _I, _P],
    # n -> frames K2 holds on the card at once (or minus a CUDA error)
    "hst_rfft_packed_stream_resident": [_I],
    # re, im, out, tw, frames, n, scale, stream
    "hst_rifft_packed_tail": [_P, _P, _P, _P, _L, _I, _F, _P],
    # xr, xi, hr, hi, yr, yi, channels, t, p, k, stream
    "hst_lag_mac_causal": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    # x, re, im, tw, batch, n, stream
    "hst_rfft_small": [_P, _P, _P, _P, _L, _I, _P],
    # sr, si, xr, xi, hr, hi, h_cstride, yr, yi, nr, ni, channels, t, p, k, stream
    "hst_lag_mac_ring": [_P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _L, _I, _I,
                         _I, _P],
    # x, h_re, h_im, h_cstride, y, scratch, gring, tw, channels, t, p, n, scale,
    # stream
    "hst_fastfir_chain": [_P, _P, _P, _L, _P, _P, _P, _P, _L, _I, _I, _I, _F, _P],
    # x, prev, rin_re, rin_im, h_re, h_im, h_cs, l0_re, l0_im, l0_cs, y, rout_re,
    # rout_im, spectra, tw, channels, t, p, n, scale, stream
    "hst_fastfir_stream": [_P, _P, _P, _P, _P, _P, _L, _P, _P, _L, _P, _P, _P, _P, _P, _L,
                           _I, _I, _I, _F, _P],
    # x, prev, rin_re, rin_im, h_re, h_im, h_cs, l0_re, l0_im, l0_cs, y, rout_re,
    # rout_im, spectra, tw, outputs, inputs, t, p, n, scale, stream
    "hst_fastfir_stream_matrix": [_P, _P, _P, _P, _P, _P, _L, _P, _P, _L, _P, _P, _P, _P, _P,
                                  _L, _L, _I, _I, _I, _F, _P],
    # xr, xi, rr, ri, hr, hi, h_cs, l0r, l0i, l0_cs, yr, yi, nr, ni, channels, t, p, k,
    # stream
    "hst_stream_state": [_P, _P, _P, _P, _P, _P, _L, _P, _P, _L, _P, _P, _P, _P, _L, _I, _I,
                         _I, _P],
    # n, p -> float2 of global ring scratch a channel (0: shared memory holds it)
    "hst_fastfir_chain_ring_scratch": [_I, _I],
    # re, im, out, tw, frames, n, stream
    "hst_rifft_packed": [_P, _P, _P, _P, _L, _I, _P],
    # re, im, y, tw, batch, n, stream
    "hst_rifft_small": [_P, _P, _P, _P, _L, _I, _P],
    # frame, frame_cstride, rin_re, rin_im, h_re, h_im, h_cstride, rout_re,
    # rout_im, y, tw, channels, p, n, scale, stream
    "hst_hop_fire": [_P, _L, _P, _P, _P, _P, _L, _P, _P, _P, _P, _L, _I, _I, _F, _P],
    # xr, xi, hr, hi, h_cstride, yr, yi, channels, tp, t, p, k, skip, stream
    "hst_lag_mac": [_P, _P, _P, _P, _L, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    # re, im, out_re, out_im, scratch, tw, batch, n, stream
    "hst_fft_split": [_P, _P, _P, _P, _P, _P, _L, _I, _P],
    # x, re, im, scratch, tw, batch, n, stream
    "hst_rfft_packed_split": [_P, _P, _P, _P, _P, _L, _I, _P],
    # re, im, out, scratch, tw, frames, n, stream
    "hst_rifft_packed_split": [_P, _P, _P, _P, _P, _L, _I, _P],
    # x, outer_stride, row_stride, t, w, re, im, tw, batch, n, stream
    "hst_rfft_small_windowed": [_P, _L, _L, _L, _P, _P, _P, _P, _L, _I, _P],
    # re, im, w, scale, y, tw, batch, n, stream
    "hst_rifft_small_windowed": [_P, _P, _P, _F, _P, _P, _L, _I, _P],
    # x, outer_stride, row_stride, t, w (or null), re, im, batch, n, stream
    "hst_rfft_tiny": [_P, _L, _L, _L, _P, _P, _P, _L, _I, _P],
    # re, im, w (or null), scale, y, batch, n, stream
    "hst_rifft_tiny": [_P, _P, _P, _F, _P, _L, _I, _P],
    # re, im, out_re, out_im, batch, n, stream
    "hst_fft_tiny": [_P, _P, _P, _P, _L, _I, _P],
    # ar, ai, a_rs, br, bi, b_rs, floor, f_rs, yr, yi, rows, k, epilogue, scale, stream
    "hst_bin_product": [_P, _P, _L, _P, _P, _L, _P, _L, _P, _P, _L, _L, _I, _F, _P],
    # xr, xi, rows, k, regularization, work, floor, stream
    "hst_bin_floor": [_P, _P, _L, _L, _F, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NoBackwardError(RuntimeError):
    """A hand kernel was asked to launch on an operand that requires grad."""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhisstools_torch_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit")


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.parent / f"{tag}.{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        text = proc.communicate()[0]
        logs.append(text)
        if proc.returncode != 0:
            failed.append(text)
    out.with_suffix(".log").write_text("".join(logs))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *[str(o) for o, _ in jobs]],
                          capture_output=True, text=True)
    for obj, _ in jobs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.hst_fastfir_chain_ring_scratch.restype = ctypes.c_longlong
            lib.hst_error_string.argtypes = [ctypes.c_int]
            lib.hst_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_tensors(kernel: str, *tensors, contiguous: bool = True) -> None:
    """Raise unless every tensor is float32, contiguous (when asked) and on
    one CUDA device (float64 raises NotImplementedError: no float64 kernel is
    ported). First of all, raise :class:`NoBackwardError` when grad is enabled
    and an operand requires grad: a launch writes its output through raw
    pointers, so the output would carry no ``grad_fn`` and a backward pass
    would silently leave this kernel's part of the function out."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NoBackwardError(
            f"{kernel}: an operand requires grad, but the hand kernels have no backward "
            "(as the TPU package's Pallas kernels have no VJP). Take gradients on CPU "
            "tensors (the plain versions) or on a path that launches no hand kernel; "
            "run inference under torch.no_grad() or torch.inference_mode()")
    for t in tensors:
        if t.dtype == torch.float64:
            raise NotImplementedError(
                f"{kernel}: no float64 kernel is ported to the GPU yet")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: needs float32, got {t.dtype}")
    for t in tensors:
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError(f"{kernel}: tensors must share one CUDA device "
                             f"(or all be on the CPU), got {t.device}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{kernel}: tensors must be contiguous")


def channel_rows(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A (C, R, K) operand as the kernels read it: rows of K contiguous floats,
    K apart, channels ``stride`` floats apart. Slices along R and views
    broadcast along C (stride 0) pass as they are; other layouts are copied.
    Returns (tensor, channel stride)."""
    if t.stride(2) != 1 or (t.shape[1] > 1 and t.stride(1) != t.shape[2]):
        t = t.contiguous()
    return t, t.stride(0)


def row_planes(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Two (C, R, K) planes as :func:`channel_rows` reads them, with one
    channel stride for both (row slices and channel-broadcast views pass in
    place). Returns (re, im, channel stride)."""
    re, cs = channel_rows(re)
    im, cs_im = channel_rows(im)
    if cs_im != cs:
        re, im, cs = re.contiguous(), im.contiguous(), re.shape[1] * re.shape[2]
    return re, im, cs


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where its data is not 16-byte aligned, as
    the ring MAC's bulk copies need."""
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def aligned_rows(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`row_planes` with every row 16-byte aligned: a plane whose start
    or channel stride is not a multiple of 4 floats is copied once."""
    re, im, cs = row_planes(re, im)
    if cs % 4 or re.data_ptr() % 16 or im.data_ptr() % 16:
        re, im, cs = row_planes(re.clone(memory_format=torch.contiguous_format),
                                im.clone(memory_format=torch.contiguous_format))
    return re, im, cs


def stream(device) -> int:
    """The current CUDA stream of ``device``, as the C entry points take it."""
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, kernel: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = load().hst_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")
