"""Bucket decode: real rows a ``_decode_bucket`` call decodes (the
program's ``rx.bucket.rows`` over ``rx.bucket.calls``, batch padding
left out) over both stretches of a traced run."""
from benchmark import program_trace as P

SPANS = ()


def read(t):
    return P.ratio("rx.bucket.rows", "rx.bucket.calls", t)
