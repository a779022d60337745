"""The two-antenna cell ``daemon_2x2_mixed_30dB`` at a small size on the
CPU (the look for a card skipped): its generator repeats and keeps every
packet owned, the program passes, its control (the bfloat16 upload)
fails, and so does each fault planted underneath the timed path, the
ZF solve without its cross term included."""
import numpy as np
import pytest

from benchmark import core, generate, generate_2x2
from benchmark.faults_2x2 import FAULTS
from benchmark.run import run_cell
from cell_small_2x2 import small_cell

SEED = 2**31 + 99


def _run(cfg=None, device="cpu"):
    bench, w, c, tr = small_cell()
    return run_cell(bench, w, cfg or c, tr, SEED, 0.2, 0, device=device)


def _failed(result) -> list[str]:
    return [k for k, c in result["checks"].items()
            if c["value"] > c["limit"]]


def test_generator_repeats_from_a_seed_and_keeps_packets_owned():
    _, _, cfg, tr = small_cell()
    geo = cfg["blocks"]
    B, H, L = (geo["owned_samples"], geo["halo_samples"],
               geo["left_context_samples"])
    with core.workers(2) as pool:
        a = generate_2x2.make(tr, cfg, 2**31 + 7, pool)
        b = generate_2x2.make(tr, cfg, 2**31 + 7, pool)
        c = generate_2x2.make(tr, cfg, 2**31 + 8, pool)
    for va, vb in zip(a["views"], b["views"]):
        assert np.array_equal(va, vb)
    assert a["sent"] == b["sent"]
    assert not np.array_equal(a["views"][0], c["views"][0])
    key = lambda f: (f["fmt"], f["mcs"], f["nss"], f["is_ndp"],
                     f["length"], tuple(len(m) for m in f["mpdus"]))
    for k, (sa, sc) in enumerate(zip(a["sent"], c["sent"])):
        # another seed orders and fills the same packets: the same work
        assert sorted(map(key, (f for _, f in sa))) == \
            sorted(map(key, (f for _, f in sc)))
        assert a["views"][k].shape == (2, L + B + H)
        for start, f in sa:
            assert L + 300 <= start < L + B - generate.OWN_MARGIN
    nss = {f["nss"] for sent in a["sent"] for _, f in sent}
    assert nss == {1, 2}


def test_program_passes():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["ndp_chan_rel_err"]["value"] > 0
    assert r["checks"]["mimo_ref_missed"]["value"] == 0


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


def test_zf_without_its_cross_term_fails_both_counts():
    """The two-stream packets the program now misses are ones the plain
    reference decodes at the same sync."""
    from gr_ieee80211_tpu_torch.models import rx as RX
    with FAULTS["zf_cross_term_dropped"](RX):
        r = _run()
    failed = _failed(r)
    assert "data_undecoded_share" in failed and "mimo_ref_missed" in failed


@pytest.mark.gpu
def test_program_passes_and_control_and_fault_fail_on_the_card(card):
    """The same runs at the small size on the card."""
    from gr_ieee80211_tpu_torch.models import rx as RX
    r = _run(device=card)
    assert r["correct"], r["checks"]
    _, _, cfg, _ = small_cell()
    cfg["engine"].update(cfg["control"]["engine"])
    assert "ndp_chan_rel_err" in _failed(_run(cfg, device=card))
    with FAULTS["zf_cross_term_dropped"](RX):
        failed = _failed(_run(device=card))
    assert "data_undecoded_share" in failed and "mimo_ref_missed" in failed
