"""Engine, all stages: host-device synchronizations a block, counted by
the program where each happens (``sync.total`` over ``rx.blocks``,
``utils/trace.py``) over both stretches of a traced run."""
from benchmark import program_trace as P

SPANS = ()


def read(t):
    return P.ratio("sync.total", "rx.blocks", t)
