"""MU station decode: the share of the rows the engine decodes that are MU
PPDUs of the station's group (the program's ``rx.mu.rows`` over
``rx.mu.rows`` + ``rx.bucket.rows``, batch padding left out) over both
stretches of a traced run; nothing where the program does not keep
``rx.mu.rows``."""
from benchmark import program_trace as P

SPANS = ()


def read(t):
    if P.trace is None or getattr(t, "device", None) is None:
        return None
    now = P.trace.snapshot()
    if "rx.mu.rows" not in now:
        return None
    d = {k: now.get(k, 0) - P.BASE.get(k, 0)
         for k in ("rx.mu.rows", "rx.bucket.rows")}
    total = d["rx.mu.rows"] + d["rx.bucket.rows"]
    return 100.0 * d["rx.mu.rows"] / total if total else None
