"""Faults planted underneath the timed path of the rx-daemon entry, each a
context manager that patches the program's module ``models/rx`` and
restores it on leaving.  The benchmark's own runs plant none: the tests
(``benchmark/tests/test_bench_checks.py``) and ``readings.py --fault``
use them to show that the comparison catches each."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def answer_altered(RX):
    """An MPDU byte altered where the result is assembled (the packet
    stays ok: a wrong answer)."""
    def make(orig):
        def altered(self, *a, **k):
            r = orig(self, *a, **k)
            if r.mpdus:
                m = r.mpdus[0]
                r.mpdus = [bytes([m[0] ^ 1]) + m[1:]] + r.mpdus[1:]
            return r
        return altered
    return _patched(RX.RxEngine, "_mk_data_result", make)


def decoded_bits_altered(RX):
    """One bit of every decoded PSDU flipped where the payload decode
    produces it (its FCS then fails: the packet comes out undecoded)."""
    def make(orig):
        def altered(*a, **k):
            out = orig(*a, **k)
            psdu = out["psdu"].clone()
            psdu[:, min(40, psdu.shape[1] - 1)] ^= 1
            out["psdu"] = psdu
            return out
        return altered
    return _patched(RX, "_payload_core", make)


def half_left_out(RX):
    """Half of each block's results left out."""
    def make(orig):
        def half(self, handle):
            res = orig(self, handle)
            return res[: len(res) // 2]
        return half
    return _patched(RX.RxEngine, "finish_process", make)


def state_unchanged(RX):
    """Each block answered with the results of the block before (the
    engine's state not moved on)."""
    def make(orig):
        last = {}

        def stale(self, handle):
            res = orig(self, handle)
            out = last.get(id(self), res)
            last[id(self)] = res
            return out
        return stale
    return _patched(RX.RxEngine, "finish_process", make)


FAULTS = {f.__name__: f for f in (answer_altered, decoded_bits_altered,
                                  half_left_out, state_unchanged)}
