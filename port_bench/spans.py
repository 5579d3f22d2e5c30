"""The program's own spans in a traced window, and each device operation put
down to the span that launched it.

The program opens ``torch.profiler.record_function`` spans named
``hst::<layer>.<name>`` while a profiler records (``<layer>`` one of
``entry``, ``engine``, ``fft``, ``kernel``); the Chrome trace holds them as
``user_annotation`` events, on the clock of the device operations. A device
operation (``kernel``, ``gpu_memcpy``, ``gpu_memset``) is joined to the
runtime or driver call that launched it (``cuda_runtime`` / ``cuda_driver``)
by ``args.correlation``; its owner is the innermost program span, on the
launching thread, that holds the launch. Where no launch event holds the
correlation, or no span on its thread holds it, the operation's ``External
id`` names the host operation that was innermost at the launch, and the
owner is the innermost program span that holds that operation.

A trace without program spans (a program that opens none) gives None, and
the metrics read from it are left out. The first reader of a run stores the
attribution in the run's ``extra`` dict for the others and logs on standard
error the spans a call, the device operations with no owner (with their
share of busy time) and each owning span's device ms a call.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

from .trace import DEVICE_CATS, HOST_CATS, is_port_kernel

PREFIX = "hst::"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no span)"

# short names of torch's device operations, for the log: the first pattern
# that matches names the operation
_KINDS = [(re.compile(p), k) for p, k in (
    (r"CatArrayBatchedCopy", "cat"), (r"FillFunctor", "fill"),
    (r"direct_copy_kernel|copy_kernel", "copy"), (r"reduce_kernel", "reduce"),
    (r"binary_internal::(\w+?)Functor", None), (r"CUDAFunctor_(\w+?)\b", None),
    (r"native::(\w+?)Functor", None))]


def kind(name: str, cat: str = "kernel") -> str:
    """A short name of a device operation: ``cat``, ``fill``, ``copy``,
    ``mul``, ``memcpy``, ... or the first 40 characters of its name."""
    if cat != "kernel":
        return cat.replace("gpu_", "")
    for pattern, k in _KINDS:
        m = pattern.search(name)
        if m:
            return k or m.group(1).lower()
    return name[:40]


def layer(span: str) -> str:
    """``hst::engine.mono.process`` -> ``engine``."""
    return span[len(PREFIX):].split(".", 1)[0]


@dataclass
class Attribution:
    """Each device operation of the window with the program span that owns
    it (None where no span does), and the entry spans' intervals."""
    ops: list = field(default_factory=list)      # (name, cat, start_us, dur_us, owner)
    spans: int = 0                                # program spans in the window
    entries: list = field(default_factory=list)  # (start_us, end_us) of entry spans


class _Thread:
    """One host thread's program spans, for the innermost one at a time."""

    def __init__(self, spans: list):
        spans.sort(key=lambda s: (s[1], -s[2]))  # by start; the outer one first
        self.spans = spans
        self.starts = [s[1] for s in spans]
        # a span no other span holds: the spans before it end before it starts
        self.top = []
        end = -float("inf")
        for _, lo, hi in spans:
            self.top.append(lo >= end)
            end = max(end, hi)

    def innermost(self, t: float):
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            name, _, hi = self.spans[i]
            if hi >= t:
                return name
            if self.top[i]:
                return None
        return None


def _thread(e: dict) -> tuple:
    return e.get("pid"), e.get("tid")


def attribute(trace) -> Attribution | None:
    """Put each device operation of ``trace`` (a :class:`trace.Trace`) down
    to its owning program span; None when the window holds no program
    span."""
    by_thread: dict = {}
    entries, launches, hosts, device = [], {}, {}, []
    lo, hi = trace.start_us, trace.start_us + trace.window_s * 1e6
    for e in trace.events:
        cat, args = e.get("cat"), e.get("args") or {}
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            s, t = max(ts, lo), min(ts + dur, hi)
            device.append((e.get("name", ""), cat, s, t - s, args))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (_thread(e), ts)
        elif cat in HOST_CATS:
            if "External id" in args:
                hosts[args["External id"]] = (_thread(e), ts)
            name = e.get("name", "")
            if cat == "user_annotation" and name.startswith(PREFIX):
                by_thread.setdefault(_thread(e), []).append((name, ts, ts + dur))
                if layer(name) == "entry":
                    entries.append((ts, ts + dur))
    if not by_thread:
        return None
    threads = {k: _Thread(v) for k, v in by_thread.items()}

    def owner_at(point):
        if point is None or point[0] not in threads:
            return None
        return threads[point[0]].innermost(point[1])

    ops = []
    for name, cat, s, dur, args in device:
        owner = owner_at(launches.get(args.get("correlation")))
        if owner is None:
            owner = owner_at(hosts.get(args.get("External id")))
        ops.append((name, cat, s, dur, owner))
    return Attribution(ops=ops, spans=sum(len(v) for v in by_thread.values()),
                       entries=sorted(entries))


def of(run) -> Attribution | None:
    """The attribution of ``run``'s traced window (``run.trace``), made once
    and kept in ``run.extra``; None without device operations in a trace,
    or without program spans."""
    if run.trace is None or not run.trace.device_ops or not run.traced_calls:
        return None
    if "spans" not in run.extra:
        run.extra["spans"] = attribute(run.trace)
        if run.extra["spans"] is not None:
            _log(run, run.extra["spans"])
    return run.extra["spans"]


def glue_ms_per_call(run, layers: tuple) -> float | None:
    """Device ms a traced call of the operations that are not the program's
    own kernels and whose owner is a span of one of ``layers``."""
    att = of(run)
    if att is None:
        return None
    port = _port_names(run)
    glue = sum(dur for name, _, _, dur, owner in att.ops
               if owner is not None and layer(owner) in layers and not port(name))
    return glue * 1e-3 / run.traced_calls


def idle_in_program_share(run) -> float | None:
    """The share of the traced window, in %, in which the device is idle
    while the host is inside an entry span (the union of the entry spans of
    every thread, overlapped with the device's idle intervals)."""
    att = of(run)
    if att is None or not att.entries or run.trace.window_s <= 0:
        return None
    merged = []
    for lo, hi in att.entries:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    idle, i = 0.0, 0
    for g_lo, g_hi in run.trace.gaps():
        while i < len(merged) and merged[i][1] <= g_lo:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < g_hi:
            idle += max(0.0, min(g_hi, merged[j][1]) - max(g_lo, merged[j][0]))
            j += 1
    return 100.0 * idle * 1e-6 / run.trace.window_s


def _port_names(run):
    """A test of whether a device operation is one of the program's kernels,
    by name, each name tested once."""
    seen: dict = {}

    def port(name: str) -> bool:
        if name not in seen:
            seen[name] = is_port_kernel(name, run.port_kernels)
        return seen[name]
    return port


def _log(run, att: Attribution) -> None:
    from .harness import log

    calls = run.traced_calls
    busy = run.trace.busy_s * 1e6
    unowned = sum(dur for _, _, _, dur, owner in att.ops if owner is None)
    log(f"spans: {att.spans / calls:.2f} program spans a traced call; device operations "
        f"with no owning span {unowned * 1e-3 / calls:.6f} ms a call, "
        f"{100.0 * unowned / busy if busy else 0.0:.4f}% of busy time")
    port = _port_names(run)
    table: dict = {}
    for name, cat, _, dur, owner in att.ops:
        row = table.setdefault(owner or NO_SPAN, {"kernels": 0.0, "glue": {}})
        if port(name):
            row["kernels"] += dur
        else:
            k = kind(name, cat)
            row["glue"][k] = row["glue"].get(k, 0.0) + dur
    ms = lambda us: us * 1e-3 / calls  # noqa: E731
    log("device ms a traced call by owning span: port kernels, glue (by kind)")
    for owner, row in sorted(table.items(), key=lambda kv: kv[0]):
        glue = sorted(row["glue"].items(), key=lambda kv: -kv[1])
        parts = ", ".join(f"{k} {ms(v):.4f}" for k, v in glue)
        log(f"  {owner}: kernels {ms(row['kernels']):.4f}, glue "
            f"{ms(sum(row['glue'].values())):.4f}" + (f" ({parts})" if parts else ""))
