"""Points transformed a call of the window: the program's ``<wrapper>.points``
counters (frames x N at each launch of a transform kernel) summed over the
window's calls, over the calls. An entry's window collects them
(``run.extra["transform_points"]``); a program without the counters gives
nothing to read."""

import importlib

WRAPPERS = ("hisstools_library_tpu_torch.fft.hopper_fft",
            "hisstools_library_tpu_torch.fft.hopper_kernels")


def total_points():
    """The sum of the program's ``points`` counters now, or None where no
    kernel wrapper has one."""
    total, found = 0, False
    for mod in WRAPPERS:
        m = importlib.import_module(mod)
        for name in dir(m):
            fn = getattr(m, name)
            if callable(fn) and isinstance(getattr(fn, "points", None), int):
                total += fn.points
                found = True
    return total if found else None


def read(run):
    points = run.extra.get("transform_points")
    if points is None or not run.calls:
        return None
    return points / run.calls
