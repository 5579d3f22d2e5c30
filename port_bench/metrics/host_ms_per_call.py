"""The host's time to enqueue one call: the harness's clock around the
entry call, which returns without a synchronise, on paced calls that each
start on an idle device (so no call waits for room in the launch queue);
the mean over those calls."""


def read(run):
    if not run.host_call_s:
        return None
    return sum(run.host_call_s) / len(run.host_call_s) * 1e3
