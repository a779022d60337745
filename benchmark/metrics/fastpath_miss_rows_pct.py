"""Kernels (decode ladder): the share of the rows handed to
``adaptive_decode`` whose re-encode syndrome is not zero, so that they
leave the algebraic fast path for the Viterbi kernels (the program's
``decode.rows_failed`` over ``decode.rows``; rows of a bucket's batch
padding included) over both stretches of a traced run."""
from benchmark import program_trace as P

SPANS = ()


def read(t):
    return P.ratio("decode.rows_failed", "decode.rows", t, 100.0)
