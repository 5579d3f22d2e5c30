"""What a traced window of calls did on the device, from the profiler's trace.

The window is profiled with ``torch.profiler`` (CPU and CUDA activity) and
read back from its Chrome trace: device operations (kernels, copies,
fills) with their start and length, the host's operations, the span of the
``port_bench.window`` annotation around the window, and every event of the
window as exported, so that a metric reader can take what these leave out
(a copy's bytes, say) from the events' ``args``. The program's own
kernels are told apart from torch's by the names of the ``__global__``
functions in the program's CUDA sources.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "port_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 96  # a breakdown entry's name is cut to this many characters

_ATTRIBUTE = re.compile(r"__\w+__\s*\(")
_NAME = re.compile(r"(\w+)\s*\($")


def _declared_name(decl: str) -> str | None:
    """The function name in a declaration's text up to its parameter list,
    with ``__attr__(...)`` qualifiers (nested parentheses and all) taken out."""
    out, i = [], 0
    while i < len(decl):
        m = _ATTRIBUTE.match(decl, i)
        if m:
            depth, i = 1, m.end()
            while i < len(decl) and depth:
                depth += {"(": 1, ")": -1}.get(decl[i], 0)
                i += 1
            continue
        out.append(decl[i])
        if decl[i] == "(":
            found = _NAME.search("".join(out))
            return found.group(1) if found else None
        i += 1
    return None


def kernel_names(csrc: Path) -> frozenset[str]:
    """The names of the ``__global__`` functions in ``csrc``'s sources."""
    names = set()
    for src in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        text = src.read_text()
        for m in re.finditer(r"__global__", text):
            name = _declared_name(text[m.end():m.end() + 400])
            if name:
                names.add(name)
    return frozenset(names)


@dataclass
class Trace:
    window_s: float                     # the traced window's length
    device_ops: list = field(default_factory=list)  # (name, start_us, dur_us), in order
    host_ops: list = field(default_factory=list)    # (name, start_us, dur_us)
    start_us: float = 0.0
    # every event of the Chrome trace that falls in the window, as exported
    # (kernels, copies with their bytes, host operations, flows), args and all
    events: list = field(default_factory=list, repr=False)
    _starts: list = field(default=None, repr=False)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0.0, -float("inf")
        for _, ts, dur in self.device_ops:
            lo, hi = max(ts, end), ts + dur
            if hi > lo:
                busy += hi - lo
            end = max(end, hi)
        return busy * 1e-6

    def gaps(self) -> list:
        """Idle intervals (start_us, end_us) of the device inside the window."""
        out, end = [], self.start_us
        for _, ts, dur in self.device_ops:
            if ts > end:
                out.append((end, ts))
            end = max(end, ts + dur)
        stop = self.start_us + self.window_s * 1e6
        if stop > end:
            out.append((end, stop))
        return out

    def host_doing(self, t_us: float) -> str:
        """The innermost host operation running at ``t_us``: of nested
        operations the inner one starts last, so the latest to start of
        those still running."""
        if self._starts is None:
            self._starts = [ts for _, ts, _ in self.host_ops]
        for i in range(bisect.bisect_right(self._starts, t_us) - 1, -1, -1):
            name, ts, dur = self.host_ops[i]
            if ts + dur > t_us and name != WINDOW:
                return name
        return "host between operations"

    def breakdown(self) -> dict:
        """The ten device operations that took most time and the ten host
        operations during which the device idled longest, in seconds."""
        by_op: dict = {}
        for name, _, dur in self.device_ops:
            key = name[:NAME_CHARS]
            by_op[key] = by_op.get(key, 0.0) + dur * 1e-6
        by_host: dict = {}
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:200]
        for lo, hi in gaps:
            key = self.host_doing(0.5 * (lo + hi))[:NAME_CHARS]
            by_host[key] = by_host.get(key, 0.0) + (hi - lo) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def from_chrome(events: list) -> Trace:
    """A :class:`Trace` of the ``port_bench.window`` span in a Chrome trace's
    event list."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
             and e.get("cat") in HOST_CATS]
    if not spans:
        raise ValueError(f"the trace holds no {WINDOW} span")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    dev, host, kept = [], [], []
    for e in events:
        if "ts" not in e:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts + dur < lo or ts > hi:
            continue
        kept.append(e)
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") in DEVICE_CATS:
            s, t = max(ts, lo), min(ts + dur, hi)
            dev.append((e.get("name", ""), s, t - s))
        elif e.get("cat") in HOST_CATS:
            host.append((e.get("name", ""), ts, dur))
    dev.sort(key=lambda d: d[1])
    host.sort(key=lambda h: h[1])
    return Trace(window_s=(hi - lo) * 1e-6, device_ops=dev, host_ops=host, start_us=lo,
                 events=kept)


def from_profile(prof) -> Trace:
    """Export a finished ``torch.profiler.profile`` and read it back. The
    file goes to the temporary directory and is removed."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return from_chrome(events)


def is_port_kernel(name: str, names: frozenset) -> bool:
    """Whether a device operation is one of the program's own kernels."""
    return any(re.search(rf"\b{re.escape(k)}\b", name) for k in names)
