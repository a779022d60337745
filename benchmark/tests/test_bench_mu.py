"""The MU station's cell ``daemon_mu_sta_30dB`` at a small size on the CPU
(the look for a card skipped): its generator repeats and keeps every
packet owned, the program passes, its control (the bfloat16 upload)
fails, and so does each fault planted underneath the timed path, the MU
payload decode on the other user's column included; a traced run reads
the cell's three MU metrics."""
import numpy as np
import pytest

from benchmark import core, generate, generate_mu
from benchmark.faults_mu import FAULTS
from benchmark.run import run_cell
from cell_small_mu import small_cell

SEED = 2**31 + 99
MU_METRICS = ("mu_rows_pct", "mu_rows_per_call", "mu_decode_ms_per_block")


def _run(cfg=None, device="cpu", trace=0):
    bench, w, c, tr = small_cell()
    return run_cell(bench, w, cfg or c, tr, SEED, 0.2, trace, device=device)


def _failed(result) -> list[str]:
    return [k for k, c in result["checks"].items()
            if c["value"] > c["limit"]]


def test_generator_repeats_from_a_seed_and_keeps_packets_owned():
    _, _, cfg, tr = small_cell()
    geo = cfg["blocks"]
    B, H, L = (geo["owned_samples"], geo["halo_samples"],
               geo["left_context_samples"])
    with core.workers(2) as pool:
        a = generate_mu.make(tr, cfg, 2**31 + 7, pool)
        b = generate_mu.make(tr, cfg, 2**31 + 7, pool)
        c = generate_mu.make(tr, cfg, 2**31 + 8, pool)
    for va, vb in zip(a["views"], b["views"]):
        assert np.array_equal(va, vb)
    assert a["sent"] == b["sent"] and a["foreign"] == b["foreign"]
    assert not np.array_equal(a["views"][0], c["views"][0])
    key = lambda f: (f["fmt"], f["mcs"], f["nss"], f["is_ndp"],
                     f["length"], f.get("nsym"),
                     tuple(len(m) for m in f["mpdus"]))
    for k, (sa, sc) in enumerate(zip(a["sent"], c["sent"])):
        # another seed orders and fills the same packets: the same work
        assert sorted(map(key, (f for _, f in sa))) == \
            sorted(map(key, (f for _, f in sc)))
        assert len(a["foreign"][k]) == len(c["foreign"][k])
        assert a["views"][k].shape == (1, L + B + H)
        for start in [s for s, _ in sa] + a["foreign"][k]:
            assert L + 300 <= start < L + B - generate.OWN_MARGIN
    kinds = {("mu" if f.get("mu") else "ndp" if f["is_ndp"] else "su")
             for sent in a["sent"] for _, f in sent}
    assert kinds == {"mu", "ndp", "su"}
    assert sum(map(len, a["foreign"])) > 0


def test_program_passes():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["ndp_chan_rel_err"]["value"] > 0
    assert r["checks"]["mu_ref_missed"]["value"] == 0
    assert r["readings"]["mu_foreign_reported"] == 0


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


def test_the_other_users_column_fails_both_counts():
    """The MU PPDUs the program now misses are ones the plain reference
    decodes at the same sync."""
    from gr_ieee80211_tpu_torch.models import rx as RX
    with FAULTS["other_users_column"](RX):
        r = _run()
    failed = _failed(r)
    assert "data_undecoded_share" in failed and "mu_ref_missed" in failed


def test_a_traced_run_reads_the_mu_metrics(monkeypatch):
    import torch
    # the run synchronizes a card around its stretches; there is none here
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    r = _run(trace=1)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert set(MU_METRICS) <= set(m)
    assert 50 < m["mu_rows_pct"]["value"] < 100
    assert m["mu_rows_per_call"]["value"] >= 1
    assert m["mu_decode_ms_per_block"]["value"] > 0


@pytest.mark.gpu
def test_program_passes_and_control_and_fault_fail_on_the_card(card):
    """The same runs at the small size on the card."""
    from gr_ieee80211_tpu_torch.models import rx as RX
    r = _run(device=card)
    assert r["correct"], r["checks"]
    _, _, cfg, _ = small_cell()
    cfg["engine"].update(cfg["control"]["engine"])
    assert "ndp_chan_rel_err" in _failed(_run(cfg, device=card))
    with FAULTS["other_users_column"](RX):
        failed = _failed(_run(device=card))
    assert "data_undecoded_share" in failed and "mu_ref_missed" in failed
