"""``tools_torch/perf_sweep.py --nss 2`` and ``--mu`` against
``tools_tpu/perf_sweep.py`` on the CPU: VHT MCS3 2 SS through the 2x2
channel at 12, 15 and 18 dB, and the two-user MU sweep at MCS3, station 0,
at 18, 21 and 24 dB; 6 packets a point.  As in
``test_torch_perf_sweep.py``: byte-equal timelines, per-slot results
equal up to the near-tie allowance, equal PERs.  The MU timelines are
byte-equal when both tools lay the same waveform: the port's transmitter
matches the JAX package's within the MU tolerance of
``tests/test_torch_tx.py``, not bit for bit, so the port tool's own MU
timeline is held to the JAX tool's within that tolerance."""
import numpy as np
import pytest
import torch

from gr_ieee80211_tpu.gold import channel as JCH, mac as JMAC
from gr_ieee80211_tpu.gold import sounding as JSND
from gr_ieee80211_tpu.models.tx import TxEngine as JTxEngine
from gr_ieee80211_tpu.spec.params import (Fmt as JFmt, MuConfig as JMu,
                                          PhyConfig as JCfg)
from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.models.tx import TxEngine
from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
from tools_torch import perf_sweep as PSW

import _perf_sweep_parity as P

torch.set_num_threads(2)

N = 6
KINDS = {
    "2ss": (["--nss", "2", "--formats", "VHT", "--mcs", "3"], (12, 19, 3)),
    "mu": (["--mu", "--mcs", "3"], (18, 25, 3)),
}
TOL_MU = 2e-5               # tests/test_torch_tx.py's MU waveform bound


def jax_mu_timeline(rng, mcs, snrs, n):
    """``tools_tpu/perf_sweep.py:38-88`` on the JAX package: (stream,
    seg, spacing, station 0's waveform, rms)."""
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
             / np.sqrt(2) for _ in range(2)]
    h_rows = np.repeat(np.stack(h_sta)[:, 0][:, :, None], 56, axis=2)
    bfq = JSND.q_to_grid(JSND.zf_q(h_rows))
    payload = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    mpdu = JMAC.qos_data_frame(payload, *P.ADDR, 7)
    psdu0 = JMAC.ampdu_aggregate_vht([mpdu])
    mpdu1 = JMAC.qos_data_frame(payload[:300], "02:00:00:00:00:11",
                                "00:c0:ca:b1:5b:e1", "02:00:00:00:00:11", 8)
    psdu1 = JMAC.ampdu_aggregate_vht([mpdu1])
    mu = JMu((JCfg(JFmt.VHT, mcs, 1, len(psdu0), ampdu=True),
              JCfg(JFmt.VHT, mcs, 1, len(psdu1), ampdu=True)), group_id=2)
    wave2 = JTxEngine().tx_mu(mu, [[psdu0], [psdu1]], bfq)[0]
    wave = JCH.apply_cfo((h_sta[0] @ wave2)[0], 800.0).astype(np.complex64)
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    nsnr = len(snrs)
    spacing = len(wave) + 400
    seg = n * spacing + 1024
    stream = np.empty(nsnr * seg, np.complex64)
    for s, snr in enumerate(snrs):
        namp = rms / 10 ** (snr / 20)
        block = (rng.normal(size=seg) + 1j * rng.normal(size=seg)
                 ).astype(np.complex64) * (namp / np.sqrt(2))
        for i in range(n):
            o = 512 + i * spacing
            block[o: o + len(wave)] += wave
        stream[s * seg: (s + 1) * seg] = block
    return stream[None], seg, spacing, wave, rms


@pytest.fixture(scope="module", params=sorted(KINDS))
def sweep(request, tmp_path_factory):
    kind = request.param
    args, snr_args = KINDS[kind]
    tmp = tmp_path_factory.mktemp(f"perf_sweep_{kind}")
    jres, calls, pres, dump = P.run_both(
        tmp, [*args, "--n", str(N), "--snrs", *map(str, snr_args)])
    assert len(calls) == 1
    snrs = np.arange(*snr_args)
    rng_j, rng_p = np.random.default_rng(2026), np.random.default_rng(2026)
    if kind == "mu":
        ref, seg, spacing, wave_j, rms = jax_mu_timeline(rng_j, 3, snrs, N)
        h_sta, bfq = PSW.mu_channels(rng_p)
        cfg, ml, w_p, _ = PSW.mu_wave(3, 500, rng_p, TxEngine(device="cpu"),
                                      h_sta[0], bfq)
        scale = np.abs(wave_j).max()
        wave_err = np.abs(w_p[0] - wave_j).max() / scale
        got, *geo_p = PSW.build_timeline(wave_j[None], rms, snrs, N, rng_p)
        name = "MU_mcs3_sta0"
    else:
        ref, seg, spacing = P.jax_timeline(rng_j, "VHT", 3, snrs, N, nss=2)
        cfg, ml, w_p, rms = PSW.siso_wave("VHT", 3, 2, 500, rng_p)
        got, *geo_p = PSW.build_timeline(w_p, rms, snrs, N, rng_p)
        wave_err = None
        name = "VHT_mcs3_2ss"
    return dict(kind=kind, name=name, jres=jres, pres=pres, call=calls[0],
                ref=ref, got=got, geo=(seg, spacing), geo_p=tuple(geo_p),
                cfg=cfg, ml=ml, nsnr=len(snrs), wave_err=wave_err,
                dump=np.load(dump / f"{name}.npz"))


def test_timelines_byte_equal(sweep):
    c = sweep
    assert c["geo"] == c["geo_p"]
    assert c["got"].dtype == c["ref"].dtype == np.complex64
    assert c["got"].shape == c["ref"].shape
    assert c["got"].tobytes() == c["ref"].tobytes()
    assert P.digest(c["ref"]) == P.digest(P.timeline(c["call"]))
    if c["kind"] == "mu":
        # the port's own MU waveform: within the MU tolerance of the JAX one
        assert c["wave_err"] < TOL_MU
    else:
        assert str(c["dump"]["digest"]) == P.digest(c["ref"])


def test_per_slot_results_equal(sweep):
    c = sweep
    call, (seg, spacing), nsnr = c["call"], c["geo"], c["nsnr"]
    ok_j, sync_j = P.slots(call["ok"], call["ltf_idx"], call["valid"], seg,
                           spacing, N, nsnr)
    x = from_numpy_cf(P.timeline(call), "cpu")
    ok, li, valid = PSW.decode(PRX, c["cfg"], x, x.shape[0], c["ml"],
                               PSW.max_pkts_for(nsnr * N), c["kind"] == "mu")
    ok_p, sync_p = P.slots(ok, li, valid, seg, spacing, N, nsnr)
    P.assert_slots_agree(c["name"], ok_j, sync_j, ok_p, sync_p, N, nsnr)
    d = c["dump"]
    ok_d, sync_d = P.slots(d["ok"], d["ltf_idx"], d["valid"], seg, spacing,
                           N, nsnr)
    P.assert_slots_agree(c["name"], ok_j, sync_j, ok_d, sync_d, N, nsnr)
    # the points straddle the waterfall
    assert not ok_j[:N].all() and ok_j[-N:].sum() >= N - 1


def test_pers_equal(sweep):
    P.assert_pers_agree(sweep["jres"], sweep["pres"], N)
