"""What the harness asks of a kind of timed call, and the window it runs in."""

from __future__ import annotations

import time

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Marks:
    """Points on the device's timeline: CUDA events, read once the window
    has closed; on the CPU the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def since_first(self) -> list:
        """Seconds from the first mark to each mark (CUDA reports the time
        between two events in float32 ms: a few microseconds late in a
        window of seconds)."""
        m = self.marks
        if self.cuda:
            return [m[0].elapsed_time(e) * 1e-3 for e in m]
        return [t - m[0] for t in m]

    def between(self, i: int, j: int) -> float:
        """Seconds from mark i to mark j."""
        m = self.marks
        if self.cuda:
            return m[i].elapsed_time(m[j]) * 1e-3
        return m[j] - m[i]


class Entry:
    """One traffic mix's timed call on one configuration.

    ``cfg`` is the configuration file, ``traffic`` the traffic file, both as
    dicts. The constructor makes the inputs from ``seed`` on ``device`` and
    sets the program up; ``call(k)`` is the k-th call of the run (warm-up
    calls included, k = 0, 1, 2, ... in order) and returns its answer, a
    (channels, samples) tensor; ``release()`` frees the program's state and
    keeps the inputs; ``reference(k, rows, precision)`` is what call k had
    to give for the channels ``rows``, from the plain reference in float64
    (or in the control's lower precision)."""

    samples_per_call: int  # channel-samples of input a call consumes

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg = cfg
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.channels = int(cfg["channels"])

    def call(self, k: int) -> torch.Tensor:
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    def reference(self, k: int, rows: slice, precision: str) -> torch.Tensor:
        raise NotImplementedError

    def work(self) -> tuple[float, float]:
        """(bytes, operations) a call has to move and compute at least."""
        raise NotImplementedError

    def window(self, k: int, seconds: float, offsets: set, slots: list, run) -> tuple:
        """The measured window, from call k until the host's clock passes its
        end, then a synchronise.

        Closed loop by default: each call is dispatched as soon as the last
        returns. Where the traffic gives ``period_s``, open loop: call j of
        the window is due j·period after its start and is dispatched then,
        without waiting for the device. Records in ``run`` each call's due
        and dispatch times and its start and end on the device's timeline
        (seconds from the window's start), its span and the host's time in
        it. The answers at ``offsets`` into the window are copied into
        ``slots`` (made in set-up, so nothing is allocated for them here),
        and the last answer is kept. Returns the kept answers by call index
        and the next call's index. An entry may override this."""
        period = self.traffic.get("period_s")
        marks = Marks(self.device)
        kept = {}
        first = k
        t0 = time.perf_counter()
        deadline = t0 + seconds
        marks.mark()  # the window's start on the device, which is idle
        while True:
            due = t0 + (k - first) * period if period else None
            while due is not None and time.perf_counter() < due:
                time.sleep(min(1e-4, max(0.0, due - time.perf_counter())))
            t = time.perf_counter()
            marks.mark()
            out = self.call(k)
            marks.mark()
            run.enqueue_s.append(time.perf_counter() - t)
            run.dispatch_s.append(t - t0)
            run.due_s.append((due if due is not None else t) - t0)
            if k - first in offsets:
                slot = slots.pop()
                same = slot.shape == out.shape and slot.dtype == out.dtype
                kept[k] = slot.copy_(out) if same else out
            k += 1
            if time.perf_counter() >= deadline:
                break
        kept.setdefault(k - 1, out)
        del out
        sync(self.device)
        run.window_s = time.perf_counter() - t0
        run.calls = k - first
        at = marks.since_first()
        run.start_s, run.done_s = at[1::2], at[2::2]
        run.call_s = [marks.between(i, i + 1) for i in range(1, len(at), 2)]
        return kept, k
