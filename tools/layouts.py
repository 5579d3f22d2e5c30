"""What the layout scripts (``tools/*_layouts.py``) share: each keeps its
table of variants and cases and the calls that launch its kernel, and this
module does the rest.

* :func:`build` copies ``hisstools_library_tpu_torch/csrc`` under
  ``build/<tool>/<variant>/``, lets the script edit the copy (most use
  :func:`edit`: exact-string replacements, each of which must match once, so
  a script whose target source has changed stops and names the text), and
  builds each variant's sources into a shared library (one ``nvcc`` each,
  all started together, ``-fno-gnu-unique`` so that each library keeps its
  own static launch state);
* :func:`ptxas` reads ptxas's register, stack and spill lines of a kernel's
  instantiations from nvcc's output;
* :func:`graph_ms`, :func:`events_ms` and :func:`device_ms` time a call on
  the card; :func:`snr` compares outputs; :func:`card` names the card and
  its power limit; :func:`variant_names` reads ``--only NAME,...``.

Needs nvcc and one CUDA card to build and time; imports nothing of JAX.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Iterable, NamedTuple, Sequence

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import graph_ms, profiled  # noqa: E402,F401  (graph_ms re-exported)
from hisstools_library_tpu_torch import _build  # noqa: E402

CSRC = ROOT / "hisstools_library_tpu_torch" / "csrc"


class Variant(NamedTuple):
    so: ctypes.CDLL
    lib: Path  # the shared library (for cuobjdump)
    log: str   # nvcc's output, with ptxas's -v lines


def replace_once(text: str, edits: Iterable, where: str) -> str:
    """``text`` with each (old, new) of ``edits`` replaced; each old must be
    in it exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{where} does not hold {old.strip()[:60]!r} once")
        text = text.replace(old, new)
    return text


def edit(directory: Path, source: str, edits: Iterable) -> None:
    """Applies ``edits`` (:func:`replace_once`) to ``source`` in a copy."""
    path = directory / source
    path.write_text(replace_once(path.read_text(), edits, f"{directory.name}: {source}"))


def build(tool: str, names: Sequence[str], sources: Sequence[str],
          change: Callable[[str, Path], None], symbols) -> Dict[str, Variant]:
    """Builds each named variant: ``csrc/`` copied under
    ``build/<tool>/<name>/``, ``change(name, dir)`` applied to the copy, its
    ``sources`` built into ``lib<tool>.so``. ``symbols`` names the C entry
    points to bind: a list takes their argtypes from ``_build._SIGNATURES``,
    a dict maps a name to (argtypes, restype or None). Variants that fail to
    build are reported with nvcc's output and left out."""
    jobs = {}
    for name in names:
        d = ROOT / "build" / tool / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        change(name, d)
        lib = d / f"lib{tool}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-shared",
             *(str(d / s) for s in sources), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log}", flush=True)
            continue
        so = ctypes.CDLL(str(lib))
        for fn in symbols:
            argtypes, restype = (symbols[fn] if isinstance(symbols, dict)
                                 else (_build._SIGNATURES[fn], None))
            getattr(so, fn).argtypes = argtypes
            if restype is not None:
                getattr(so, fn).restype = restype
        out[name] = Variant(so, lib, log)
    return out


def ptxas(log: str, kernel: str, what: Sequence[str] = ("registers", "stack frame")) -> dict:
    """ptxas's lines that hold one of ``what``, by the mangled name of each
    entry function whose name holds ``kernel``."""
    out, entry = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif kernel in entry and any(w in line for w in what):
            out.setdefault(entry, []).append(line.split("ptxas info    :")[-1].strip())
    return out


def events_ms(call, runs: int = 20) -> float:
    """Median ms of a call between CUDA events, after a warm-up (the
    host's launch time included)."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_ms(call, runs: int = 10) -> Dict[str, float]:
    """Device ms per call of each CUDA kernel ``call`` launches, by name
    (``torch.profiler``, mean of ``runs`` after a warm-up;
    ``chip_smoke.profiled``)."""
    return {e.key: e.device_time_total / runs / 1e3 for e in profiled(call, runs)}


def device_ms(call, runs: int = 10) -> float:
    """Device ms per call of all the CUDA kernels ``call`` launches."""
    return sum(kernel_ms(call, runs).values())


def snr(want, got) -> float:
    """SNR in dB of ``got`` against ``want``: two tensors, or two sequences
    of tensors taken together."""
    if isinstance(want, torch.Tensor):
        want, got = (want,), (got,)
    err = sum(float(((g.double() - w.double()) ** 2).sum()) for w, g in zip(want, got))
    ref = sum(float((w.double() ** 2).sum()) for w in want)
    return float("inf") if err == 0 else float(10 * np.log10(ref / err))


def card(tool: str) -> str:
    """The card's name and power limit as nvidia-smi prints them; exits
    without a CUDA card."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def variant_names(args: Sequence[str], table, doc: str) -> list:
    """The variants ``--only NAME,...`` names (all of ``table`` without it);
    any other argument prints ``doc`` and exits."""
    if list(args[:1]) == ["--only"] and len(args) == 2:
        names = args[1].split(",")
        unknown = [n for n in names if n not in table]
        if unknown:
            raise SystemExit(f"no variant {', '.join(unknown)}; the variants: {', '.join(table)}")
        return names
    if args:
        raise SystemExit(doc)
    return list(table)
