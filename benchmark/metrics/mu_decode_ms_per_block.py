"""MU station decode: ms a block the host spends in the engine's MU decode
(the program's ``rx.mu`` spans: SIG-B pass, payload decodes, result
assembly), from the program's own span clock (``trace.spans()``) over
both stretches of a traced run: their summed duration over the receive
blocks the recorded spans belong to; nothing where the program records
no ``rx.mu`` span or no block ids."""
from benchmark import program_trace as P

SPANS = ()


def read(t):
    if P.trace is None or getattr(t, "device", None) is None:
        return None
    spans = P.trace.spans()
    mu = [s.t1 - s.t0 for s in spans if s.name == "rx.mu"]
    blocks = {s.block for s in spans if s.block is not None}
    if not mu or not blocks:
        return None
    return 1e3 * sum(mu) / len(blocks)
