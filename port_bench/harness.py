"""One run of one cell: set-up, warm-up, the measured window, the check.

Everything that belongs to one configuration, one traffic mix or one metric
is found by name: ``BENCHMARK.json`` names a cell's configuration (its
``file``) and traffic (``traffic/<traffic>.json``); the traffic file names
its kind of call (``entries/<entry>.py``), which runs the measured window
(``Entry.window``: closed loop, or open loop at the traffic's ``period_s``);
every metric the cell reports is read by ``metrics/<metric>.py`` from the
``Run`` the window filled.
"""

from __future__ import annotations

import importlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import signals, trace as trace_mod
from .entry import sync
from .reference import convolution

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CSRC = ROOT / "hisstools_library_tpu_torch" / "csrc"

# the traced run's two short parts after the window, each at least this
# long and this many calls
PART_SECONDS = 1.0
PART_CALLS = 5


def log(msg: str) -> None:
    print(f"port_bench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its configuration and traffic files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=workload, chips=int(w["chips"]),
                config=load_json(root / cfg_entry["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def entry_class(traffic: dict):
    return importlib.import_module(f"port_bench.entries.{traffic['entry']}").Entry


def metric_reader(name: str):
    return importlib.import_module(f"port_bench.metrics.{name}").read


@dataclass
class Run:
    """What a run measured, for the metric readers. The window's lists hold
    one entry a call, in seconds; times are from the window's start."""
    setup_s: float
    window_s: float = 0.0
    calls: int = 0
    samples_per_call: int = 0
    due_s: list = field(default_factory=list)        # when each call was due (host)
    dispatch_s: list = field(default_factory=list)   # when it was dispatched (host)
    enqueue_s: list = field(default_factory=list)    # the host's time in it
    start_s: list = field(default_factory=list)      # its first launch (device)
    done_s: list = field(default_factory=list)       # its last launch's end (device)
    call_s: list = field(default_factory=list)       # its span on the device
    host_call_s: list = field(default_factory=list)  # the paced calls' enqueue
    trace: object = None                             # trace.Trace of the traced part
    traced_calls: int = 0
    work: tuple = (0.0, 0.0)                         # (bytes, operations) a call
    port_kernels: frozenset = frozenset()
    extra: dict = field(default_factory=dict)        # what an entry's own window adds


def check_answers(entry, kept: dict, limits: dict, precision: str = "float64"):
    """The compared numbers of the kept answers, each with its limit, and the
    number of answers over a limit.

    ``rel_err``: the largest over answers and channels of a channel's
    ||answer - reference|| / ||reference||, the reference in float64. With
    ``precision`` other than float64, the reference in that precision takes
    the program's place (the control)."""
    worst, failed = 0.0, 0
    for k, out in sorted(kept.items()):
        answer = 0.0
        for i in range(0, entry.channels, convolution.ROWS):
            rows = slice(i, i + convolution.ROWS)
            want = entry.reference(k, rows, "float64")
            got = out[rows] if precision == "float64" else entry.reference(k, rows, precision)
            err = (float(convolution.relative_errors(got, want).max())
                   if got.shape == want.shape else math.inf)
            answer = err if math.isnan(err) else max(answer, err)
        failed += not answer <= limits["rel_err"]
        worst = answer if math.isnan(answer) or math.isnan(worst) else max(worst, answer)
    return {"rel_err": {"value": worst, "limit": limits["rel_err"]}}, failed


def warm_up(entry, traffic: dict, device: torch.device) -> tuple:
    """The traffic's warm-up calls (k = 0, 1, ...), each waited for: the
    shortest one's seconds after the first, and the last answer."""
    warm = []
    for k in range(int(traffic["warmup_calls"])):
        t = time.perf_counter()
        out = entry.call(k)
        sync(device)
        warm.append(time.perf_counter() - t)
    return min(warm[1:] or warm), out


def answers_to_keep(seed: int, traffic: dict, seconds: float, t_call: float) -> set:
    """Offsets into the window of the answers to check, drawn from the seed
    among the calls the window is expected to hold (its last is kept too)."""
    t_call = max(t_call, float(traffic.get("period_s", 0.0)))
    est = max(1, int(seconds / max(t_call, 1e-6)))
    rng = signals.numpy_rng(seed, "sample")
    return {int(o) for o in rng.choice(est, size=min(int(traffic["answers"]), est),
                                       replace=False)}


def slots_for(offsets: set, answer: torch.Tensor) -> list:
    """A tensor like ``answer`` for each kept answer, made before the window."""
    return [torch.empty_like(answer) for _ in offsets]


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
             t_start: float, entry_cls=None) -> dict:
    """Set up, warm up, run the window and check: the result's fields."""
    traffic = cell.traffic
    entry = (entry_cls or entry_class(traffic))(cell.config, traffic, seed, device)
    log(f"set-up: inputs made and the program set up at {time.perf_counter() - t_start:.3f} s")
    t_call, answer = warm_up(entry, traffic, device)
    offsets = answers_to_keep(seed, traffic, seconds, t_call)
    slots = slots_for(offsets, answer)
    del answer
    log(f"set-up: warmed up at {time.perf_counter() - t_start:.3f} s "
        f"(the fastest warm-up call {t_call * 1e3:.3f} ms)")
    launches = _launch_counters()
    for fn in launches.values():
        fn.launches = 0
    run = Run(setup_s=time.perf_counter() - t_start, samples_per_call=entry.samples_per_call,
              work=entry.work())
    kept, k = entry.window(int(traffic["warmup_calls"]), seconds, offsets, slots, run)
    per_call = {name: fn.launches / run.calls for name, fn in launches.items() if fn.launches}
    log(f"launches a call by kernel wrapper: {per_call}")

    if traced:
        _traced_parts(entry, k, run, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"peak memory {peak} bytes (torch.cuda.max_memory_allocated)")

    entry.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks, failed = check_answers(entry, kept, traffic["limits"])
    log(f"checked {len(kept)} answers (calls {sorted(kept)}) against the float64 "
        f"reference in {time.perf_counter() - t:.3f} s")
    ok = failed == 0

    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if device.type == "cuda":
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                       "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": ok, "attempted": run.calls, "failed": failed, "metrics": metrics,
              "device": device_info}
    if traced and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result


def _traced_parts(entry, k: int, run: Run, device: torch.device) -> None:
    """After the window, from call k: paced calls, each alone on an idle
    device, for the host's enqueue time; then calls dispatched ahead as in
    the window under the profiler."""
    t_end = time.perf_counter() + PART_SECONDS
    while len(run.host_call_s) < PART_CALLS or time.perf_counter() < t_end:
        sync(device)
        t = time.perf_counter()
        entry.call(k)
        run.host_call_s.append(time.perf_counter() - t)
        k += 1
    sync(device)
    if device.type != "cuda":
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace_mod.WINDOW):
            first = k
            t_end = time.perf_counter() + PART_SECONDS
            while k - first < PART_CALLS or time.perf_counter() < t_end:
                entry.call(k)
                k += 1
            torch.cuda.synchronize(device)
    run.traced_calls = k - first
    run.port_kernels = trace_mod.kernel_names(CSRC)
    t = time.perf_counter()
    run.trace = trace_mod.from_profile(prof)
    log(f"traced {run.traced_calls} calls: {len(run.trace.device_ops)} device operations, "
        f"read in {time.perf_counter() - t:.3f} s")


def _launch_counters() -> dict:
    """The program's kernel wrappers, each with its ``launches`` count."""
    out = {}
    for mod in ("hisstools_library_tpu_torch.fft.hopper_fft",
                "hisstools_library_tpu_torch.fft.hopper_kernels"):
        m = importlib.import_module(mod)
        for name in dir(m):
            fn = getattr(m, name)
            if callable(fn) and hasattr(fn, "launches"):
                out[name] = fn
    return out

