"""The faults of the MU station's cell: ``faults.py``'s, planted underneath
the timed path as there, and one in the MU payload decode.  The
benchmark's own runs plant none: the tests
(``benchmark/tests/test_bench_mu.py``) use them to show that the
comparison catches each."""
from __future__ import annotations

from .faults import FAULTS as SHARED
from .faults import _patched


def other_users_column(RX):
    """The MU payload decode handed the other user's column of the
    channel estimate (at position 1: ``own`` 0, the stream that zero
    forcing nulls at this station), where the engine's MU decode calls
    ``models.rx._payload_core_mu``, on the card as on the CPU."""
    def make(orig):
        def other(cfg, stream, ltf_idx, cfo, n_total, own, *a, **k):
            return orig(cfg, stream, ltf_idx, cfo, n_total,
                        (own + 1) % n_total, *a, **k)
        return other
    return _patched(RX, "_payload_core_mu", make)


FAULTS = dict(SHARED, other_users_column=other_users_column)
