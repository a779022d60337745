"""MU station decode: real rows a ``_payload_core_mu`` call of the engine
decodes (the program's ``rx.mu.call_rows`` over ``rx.mu.calls``, batch
padding left out) over both stretches of a traced run; nothing where the
program does not keep those counters."""
from benchmark import program_trace as P

SPANS = ()


def read(t):
    if P.trace is None or "rx.mu.calls" not in P.trace.snapshot():
        return None
    return P.ratio("rx.mu.call_rows", "rx.mu.calls", t)
