"""Builds and loads the port's two host libraries, the real-time runtime
(``native/rt_runtime.cpp``, :mod:`.utils.native_rt`) and the PCM codec
(``native/hisstools_codec.cpp``, :mod:`.io.native_codec`).

Each is compiled with ``g++`` on first use (never at import) into
``build/hisstools_torch_native/`` beside the package, named by a hash of its
source and flags, so an edit gives a new build and the JAX package's own
outputs in ``native/`` are never touched. The compiler writes a name of its
own and the library is moved into place with ``os.replace``, so a process
that loads it at the same moment (test workers, another package's build)
never sees a half-written file. One lock covers every build and load, as
the loader thread of a server may be the first caller. A failed build or
load gives None, and the callers report the library unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "hisstools_torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def library_path(source: str, flags: Sequence[str] = ()) -> Path:
    """Where the library built from ``native/<source>`` is (or will be)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(flags)).encode())
    h.update((NATIVE / source).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def _build(source: str, flags: Sequence[str], out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, *flags, "-o", str(tmp),
                        str(NATIVE / source)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load(source: str, flags: Sequence[str],
         bind: Callable[[ctypes.CDLL], None]) -> Optional[ctypes.CDLL]:
    """The library built from ``native/<source>`` with ``flags``, its
    signatures set by ``bind``; None when it cannot be built or loaded.
    The first call decides, and later calls return its result."""
    with _lock:
        if source not in _libs:
            _libs[source] = None
            if (NATIVE / source).exists():
                out = library_path(source, flags)
                if out.exists() or _build(source, flags, out):
                    try:
                        lib = ctypes.CDLL(str(out))
                    except OSError:
                        lib = None
                    if lib is not None:
                        bind(lib)
                        _libs[source] = lib
        return _libs[source]
