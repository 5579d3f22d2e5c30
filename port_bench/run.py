"""The benchmark of the PyTorch / CUDA port: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for. Makes the cell's inputs on the card from the seed, sets the program up
and warms it up (``setup_s``), dispatches calls for ``--seconds``, checks
sampled answers against the float64 reference, and prints one JSON object as
the last line of standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a profiled part after
the window. Earlier lines go to standard error; its last lines are the
compared numbers with their limits. Exits with another code than 0, and
prints no result, without the cards, without the program, or when the
process holds JAX or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "port_bench"
PROGRAM = "hisstools_library_tpu_torch"
# top-level modules the process may not hold once the window has closed
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hisstools_library_tpu"})


def _environment() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules) -> list:
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().replace("\n", "; ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import harness

    t_torch = time.perf_counter() - T_START
    cell = harness.find_cell(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    program = __import__(PROGRAM)
    if Path(program.__file__).resolve().parent.parent != ROOT:
        harness.log(f"{PROGRAM} is imported from {program.__file__}, not this checkout")
        return 2
    torch.cuda.init()
    harness.log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}; {torch.cuda.get_device_name(0)}; "
                f"nvidia-smi: {_power_limit()}")
    harness.log(f"set-up: torch imported at {t_torch:.3f} s, the card reached at "
                f"{time.perf_counter() - T_START:.3f} s")

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)

    found = forbidden_modules(sys.modules)
    if found:
        harness.log(f"the process holds {found}: the benchmark may not load JAX or the "
                    "JAX package")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
        if not math.isfinite(c["value"]):  # JSON has no inf or NaN
            c["value"] = repr(c["value"])
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
