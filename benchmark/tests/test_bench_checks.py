"""The comparison that decides ``correct``, driven through a whole run at
a small size on the CPU (the look for a card skipped): the program passes,
its control (the configuration's lower-precision path) fails, and so does
each fault the cell can have, planted underneath the timed path."""
import numpy as np
import pytest

from benchmark.faults import FAULTS
from benchmark.run import run_cell
from cell_small import small_cell

SEED = 2**31 + 99


def _run(cfg=None):
    bench, w, c, tr = small_cell()
    return run_cell(bench, w, cfg or c, tr, SEED, 0.2, 0, device="cpu")


def _failed(result) -> list[str]:
    return [k for k, c in result["checks"].items()
            if c["value"] > c["limit"]]


def test_program_passes():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["ndp_chan_rel_err"]["value"] > 0


def test_control_fails():
    _, _, cfg, _ = small_cell()
    cfg["engine"].update(cfg["control"]["engine"])
    r = _run(cfg)
    assert not r["correct"]
    assert "ndp_chan_rel_err" in _failed(r)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_fails(fault):
    from gr_ieee80211_tpu_torch.models import rx as RX
    with FAULTS[fault](RX):
        r = _run()
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] > 0


def test_undecoded_packets_fail_their_share():
    """Decoded bits altered where the decoder makes them: the packets
    come out not ok, which only the undecoded share catches."""
    from gr_ieee80211_tpu_torch.models import rx as RX
    with FAULTS["decoded_bits_altered"](RX):
        r = _run()
    assert _failed(r) == ["data_undecoded_share"], r["checks"]


def test_ndp_estimate_is_held_at_the_programs_own_sync():
    """A channel estimate off by one part in 10^4 fails its limit."""
    from gr_ieee80211_tpu_torch.models import rx as RX
    orig = RX._ndp_chan_core

    def scaled(*a, **k):
        h = orig(*a, **k)
        return type(h)(h.re * np.float32(1 + 1e-4), h.im)
    mp = pytest.MonkeyPatch()
    mp.setattr(RX, "_ndp_chan_core", scaled)
    try:
        r = _run()
    finally:
        mp.undo()
    assert "ndp_chan_rel_err" in _failed(r)


@pytest.mark.gpu
def test_program_passes_and_control_fails_on_the_card(card):
    """The same run at the small size on the card: the kernels launch
    instead of their twins; the comparison still separates the two."""
    bench, w, cfg, tr = small_cell()
    r = run_cell(bench, w, cfg, tr, SEED, 0.2, 0, device=card)
    assert r["correct"], r["checks"]
    cfg["engine"].update(cfg["control"]["engine"])
    r = run_cell(bench, w, cfg, tr, SEED, 0.2, 0, device=card)
    assert "ndp_chan_rel_err" in _failed(r)
