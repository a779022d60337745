"""The faults of the two-antenna cell: ``faults.py``'s, planted underneath
the timed path as there, and one in the two-stream equalizer.  The
benchmark's own runs plant none: the tests
(``benchmark/tests/test_bench_2x2.py``) use them to show that the
comparison catches each."""
from __future__ import annotations

import contextlib

from .faults import FAULTS as SHARED


def zf_cross_term_dropped(RX):
    """The two-stream ZF solve without its cross term g01 = h0^H h1: each
    stream divided by its own channel energy (a matched filter), so the
    other stream's leakage stays in the symbols."""
    import torch
    OF = RX.OF
    orig = OF.zf_equalize

    def dropped(y, hd):
        B, nrx = hd.shape[:2]
        out = []
        for s in range(2):
            h = hd[:, :, s]
            g = h.abs2().sum(dim=1)
            r = OF.csum(h.conj().reshape(B, nrx, 1, -1) * y, dim=1)
            out.append(r * (1.0 / torch.clamp(g, min=1e-20))[:, None, :])
        return OF.CF(torch.stack([o.re for o in out], dim=1),
                     torch.stack([o.im for o in out], dim=1))

    @contextlib.contextmanager
    def planted():
        OF.zf_equalize = dropped
        try:
            yield
        finally:
            OF.zf_equalize = orig
    return planted()


FAULTS = dict(SHARED, zf_cross_term_dropped=zf_cross_term_dropped)
