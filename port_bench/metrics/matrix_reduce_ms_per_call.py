"""Device ms a traced call of the operations whose owner (the innermost
program span that holds the launch, ``port_bench.spans``) is an
``hst::engine.matrix.*`` span: the N-in / M-out matrix's sum over inputs,
and any copy of the broadcast inputs made there. A trace without such a
span (a program that opens none) gives nothing to read."""

from port_bench.spans import PREFIX, of

MATRIX = PREFIX + "engine.matrix."


def read(run):
    att = of(run)
    if att is None or not any(e.get("cat") == "user_annotation"
                              and str(e.get("name", "")).startswith(MATRIX)
                              for e in run.trace.events):
        return None
    us = sum(dur for _, _, _, dur, owner in att.ops
             if owner is not None and owner.startswith(MATRIX))
    return us * 1e-3 / run.traced_calls
