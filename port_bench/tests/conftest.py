"""The harness's tests: the checkout's root on the import path, and tiny
cells that run on the port's CPU paths in a fraction of a second."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402

# Each configuration and traffic mix cut to a size the CPU runs at once;
# widths a cell does not name stay as the files give them.
TINY_CONFIG = {"channels": 3, "ir_taps": 3000}
TINY = {  # by the traffic's entry: (configuration, traffic)
    "convolver_stream": ({}, {"block": 8192, "pool_blocks": 3}),
    "convolver_offline": ({}, {"file_samples": 5000, "pool": 2}),
    "spectral_convolve": ({}, {"signal_seconds": 0.1, "pool": 2}),
    "ir_deconvolve": ({"sample_rate": 8000, "sweep_seconds": 0.5},
                      {"capture_seconds": 0.75, "pool": 2}),
}


@pytest.fixture(scope="session")
def bench():
    return harness.load_json(ROOT / "BENCHMARK.json")


def tiny_cell(bench, workload):
    cell = harness.find_cell(bench, workload)
    config, traffic = TINY[cell.traffic["entry"]]
    cell.config = {**copy.deepcopy(cell.config), **TINY_CONFIG, **config}
    cell.traffic = {**copy.deepcopy(cell.traffic), **traffic}
    return cell
