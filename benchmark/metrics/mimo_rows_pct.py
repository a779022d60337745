"""Bucket decode, 2 streams: the share of the real rows of ``_decode_bucket``
calls whose canonical config has two spatial streams (the program's
``rx.bucket.rows_2ss`` over ``rx.bucket.rows``, batch padding left out)
over both stretches of a traced run; nothing where the program does not
keep that counter."""
from benchmark import program_trace as P

SPANS = ()


def read(t):
    if P.trace is None or "rx.bucket.rows_2ss" not in P.trace.snapshot():
        return None
    return P.ratio("rx.bucket.rows_2ss", "rx.bucket.rows", t, 100.0)
