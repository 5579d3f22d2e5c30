"""Channel-samples of input the window's calls consumed, over the window's
seconds on the host's clock (from its first dispatch to a synchronise after
its last call)."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return run.calls * run.samples_per_call / run.window_s
