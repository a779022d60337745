"""The MU-MIMO station's receive path of the port (on the CPU) vs the JAX
package's on the same seeded streams, and the sounding loop closed on the
port alone.

Exact: VHT-SIG-B bits, PSDU bytes, SERVICE bits, FCS flags, the ok /
ltf_idx / valid vectors of ``rx_chain_ok_mu`` and every field of the
engine's MU results that ``test_torch_engine.assert_same_results`` holds
exact (the floats within its stated tolerances).  The Viterbi kernels'
plain twins decode here, as the Pallas kernels' interpret mode does in the
reference.
"""
import numpy as np
import pytest
import torch

from gr_ieee80211_tpu.gold import channel, mac, sounding, tx as gtx
from gr_ieee80211_tpu.models import rx as JRX
from gr_ieee80211_tpu.ops.cplx import from_host
from gr_ieee80211_tpu.spec.params import Fmt, MuConfig, PhyConfig
from gr_ieee80211_tpu_torch.gold import channel as PCH, mac as PMAC
from gr_ieee80211_tpu_torch.gold import rx as PGRX, sig as PSIG
from gr_ieee80211_tpu_torch.gold import sounding as PSND, tx as PGTX
from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.models.tx import TxEngine
from gr_ieee80211_tpu_torch.ops import viterbi_kernels as PVK
from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
from gr_ieee80211_tpu_torch.spec import params as PP
from gr_ieee80211_tpu_torch.spec import tables as PT
from gr_ieee80211_tpu_torch.spec.params import from_reference
from test_torch_engine import (EXACT, assert_same_results, assert_same_starts,
                               ltf_metric_as_measured)

torch.set_num_threads(2)

AP = "02:00:00:00:00:01"
STA = ("02:00:00:00:00:10", "02:00:00:00:00:11")


def _h_sta(rng):
    return [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
            / np.sqrt(2) for _ in range(2)]


def _mu_frames(texts=(b"user zero data " * 8, b"USER ONE DATA " * 6)):
    """(mu config of the JAX package, A-MPDUs, MPDUs): user 0 VHT MCS3,
    user 1 MCS2, group id 2 (the frames of tests/test_mu_fused.py)."""
    mpdus = [mac.qos_data_frame(t, STA[u], AP, STA[u], 5 + u)
             for u, t in enumerate(texts)]
    ams = [mac.ampdu_aggregate_vht([m]) for m in mpdus]
    mu = MuConfig((PhyConfig(Fmt.VHT, 3, 1, len(ams[0]), ampdu=True),
                   PhyConfig(Fmt.VHT, 2, 1, len(ams[1]), ampdu=True)),
                  group_id=2)
    return mu, ams, mpdus


def _flat_q(h_sta):
    h_rows = np.repeat(np.stack(h_sta)[:, 0][:, :, None], 56, axis=2)
    return sounding.q_to_grid(sounding.zf_q(h_rows))


def _mu_stream(rng, n_pkts, h_sta, user=0, snr_db=32.0):
    """``n_pkts`` copies of one ZF-precoded MU PPDU as station ``user``
    hears it (150 Hz CFO, 400-sample gaps) + AWGN: (stream (N,), mu, mpdus)."""
    mu, ams, mpdus = _mu_frames()
    wave = gtx.tx_waveform_mu(mu, ams, _flat_q(h_sta))
    burst = channel.mimo_channel(wave, h_sta[user])
    one = channel.frame_stream(burst, 1.0, 150.0, gap=400)[0]
    stream = np.concatenate([np.zeros(512, np.complex64)]
                            + [one.astype(np.complex64)] * n_pkts)
    return channel.awgn(stream, 0.012 / 10 ** (snr_db / 20), rng), mu, mpdus


def _own_cfg(mu, u, mcs=None):
    uc = mu.users[u]
    return PhyConfig(Fmt.VHT, uc.mcs if mcs is None else mcs, 1, uc.psdu_len,
                     ampdu=True, mu_nsym=mu.nsym)


def _counts(mod, cfg, dev, own, mpdu_len, **kw):
    return tuple(int(x) for x in mod.rx_chain_count_mu(
        cfg, dev, n_total=2, own=own, nrx=1, mpdu_len=mpdu_len, max_pkts=16,
        **kw))


def _both_counts(cfg, stream, own, mpdu_len):
    ref = _counts(JRX, cfg, from_host(stream[None]), own, mpdu_len)
    got = _counts(PRX, from_reference(cfg), from_numpy_cf(stream[None], "cpu"),
                  own, mpdu_len)
    assert got == ref
    return got


def _synced(stream, cfg):
    """(ltf_idx, cfo) of the detected packets, from the port's front end,
    as numpy: the same rows go into both packages' cores."""
    n_need = PRX._mu_starts(2)[3] + 80 * cfg.nsym + 16
    _, ltf_c, cfo, valid = PRX._detect_sync(
        from_reference(cfg), from_numpy_cf(stream[None], "cpu"), 16,
        n_need=n_need)
    return ltf_c[valid].numpy(), cfo[valid].numpy()


@pytest.mark.parametrize("user", [0, 1])
def test_mu_sigb_core_bits_equal(user):
    """VHT-SIG-B of each user from the full 2-stream channel estimate: the
    26 decoded bits equal the reference's and the transmitted ones."""
    rng = np.random.default_rng(21 + user)
    stream, mu, _ = _mu_stream(rng, 4, _h_sta(rng), user)
    ltf, cfo = _synced(stream, _own_cfg(mu, user))
    assert len(ltf) == 4
    ref = np.asarray(JRX._mu_sigb_core(
        from_host(stream), np.asarray(ltf), np.asarray(cfo), 2, user))
    got = PRX._mu_sigb_core(from_numpy_cf(stream, "cpu"),
                            torch.from_numpy(ltf), torch.from_numpy(cfo), 2,
                            user)
    assert got.dtype == torch.uint8 and got.shape == (4, 26)
    assert np.array_equal(ref, got.numpy())
    sent, _crc = PSIG.vhtsigb_bits_mu(from_reference(mu.users[user]))
    assert np.array_equal(got.numpy(), np.tile(sent[:26], (4, 1)))


@pytest.mark.parametrize("user,snr_db", [(0, 32.0), (1, 32.0), (0, 10.0)])
def test_payload_core_mu_equal(user, snr_db):
    """The MU payload decode on the same sync rows: PSDU bytes, SERVICE
    bits and FCS flags equal, at a clean SNR and at one where rows carry
    channel errors (the Viterbi twins decode in both)."""
    rng = np.random.default_rng(31 + user)
    stream, mu, mpdus = _mu_stream(rng, 5, _h_sta(rng), user, snr_db)
    cfg = _own_cfg(mu, user)
    ltf, cfo = _synced(stream, cfg)
    assert len(ltf) == 5
    ml = len(mpdus[user])
    ref = JRX._payload_core_mu(cfg, from_host(stream[None]), np.asarray(ltf),
                               np.asarray(cfo), 2, user, nrx=1, mpdu_len=ml)
    rec = []
    got = PRX._payload_core_mu(
        from_reference(cfg), from_numpy_cf(stream[None], "cpu"),
        torch.from_numpy(ltf), torch.from_numpy(cfo), 2, user, nrx=1,
        mpdu_len=ml, record=rec)
    assert sorted(got) == sorted(ref) == ["mpdu_fcs_ok", "psdu", "service"]
    for k in got:
        assert np.array_equal(np.asarray(ref[k]), got[k].numpy()), k
    assert got["psdu"].shape == (5, cfg.psdu_len)
    assert len(rec) == 1
    if snr_db > 30:
        assert bool(got["mpdu_fcs_ok"].all())


def test_crc8_affine_and_sigb_crc_ok():
    """The affine CRC8 map equals the bit-serial oracle and the
    reference's matrices; ``_sigb_crc_ok`` flags equal on random SIG-B /
    SERVICE rows, half of them made valid."""
    rng = np.random.default_rng(5)
    M, c0 = PRX._crc8_affine()
    Mj, c0j = JRX._crc8_affine()
    assert np.array_equal(M, Mj) and np.array_equal(c0, c0j)
    sigb = rng.integers(0, 2, (64, 26)).astype(np.uint8)
    service = rng.integers(0, 2, (64, 16)).astype(np.uint8)
    for i in range(64):
        crc = PT.crc8_bits(sigb[i, :20])
        assert np.array_equal((M @ sigb[i, :20] + c0) % 2, crc)
        if i % 2 == 0:
            service[i, 8:] = crc
            sigb[i, 20:] = 0
    sigb[0, 22] = 1                      # valid CRC, nonzero tail
    ref = np.asarray(JRX._sigb_crc_ok(sigb, service))
    got = PRX._sigb_crc_ok(torch.from_numpy(sigb), torch.from_numpy(service))
    assert got.dtype == torch.bool and np.array_equal(ref, got.numpy())
    assert not got[0] and int(got.sum()) >= 31


def test_rx_chain_count_mu_fused():
    rng = np.random.default_rng(11)
    stream, mu, mpdus = _mu_stream(rng, 3, _h_sta(rng))
    assert _both_counts(_own_cfg(mu, 0), stream, 0, len(mpdus[0])) == (3, 3)


def test_rx_chain_count_mu_rejects_wrong_mcs():
    """A config that claims the wrong MCS: the SIG-B MCS check zeroes the
    ok count."""
    rng = np.random.default_rng(12)
    stream, mu, mpdus = _mu_stream(rng, 2, _h_sta(rng))
    cfg = _own_cfg(mu, 0, mcs=mu.users[0].mcs + 1)
    assert _both_counts(cfg, stream, 0, len(mpdus[0])) == (0, 2)


def test_port_mu_tx_to_fused_mu_rx_loopback():
    """The port's own loop: ``TxEngine.tx_mu`` -> ZF channel -> the MU-STA
    chain, for both users."""
    rng = np.random.default_rng(14)
    h_sta = _h_sta(rng)
    mu, ams, mpdus = _mu_frames((b"device mu user0 " * 7,
                                 b"device mu user1 " * 5))
    wave = TxEngine(device="cpu").tx_mu(from_reference(mu),
                                        [[ams[0]], [ams[1]]],
                                        _flat_q(h_sta))[0]
    for u in range(2):
        burst = channel.mimo_channel(wave, h_sta[u])
        one = channel.frame_stream(burst, 1.0, 150.0, gap=400)[0]
        stream = np.concatenate([np.zeros(512, np.complex64)]
                                + [one.astype(np.complex64)] * 3)
        stream = channel.awgn(stream, 0.012 / 10 ** (32 / 20), rng)
        got = _counts(PRX, from_reference(_own_cfg(mu, u)),
                      from_numpy_cf(stream[None], "cpu"), u, len(mpdus[u]))
        assert got == (3, 3), u


def test_ndp_chan_core_batched_matches_engine():
    """Three NDPs on two antennas: one batched channel estimate, equal
    across the NDPs and to the reference engine's."""
    rng = np.random.default_rng(13)
    h = (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))) / np.sqrt(2)
    ndp = gtx.tx_waveform(PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True), b"",
                          group_id=0, partial_aid=0)
    one = channel.frame_stream(channel.mimo_channel(ndp, h), 1.0, 120.0,
                               gap=400)
    stream = np.concatenate([np.zeros((2, 256), np.complex64)]
                            + [one.astype(np.complex64)] * 3, axis=1)
    stream = channel.awgn(stream, 0.01 / 10 ** (35 / 20), rng)
    ref = JRX.RxEngine(nrx=2).process(stream)
    got = PRX.RxEngine(nrx=2, device="cpu").process(stream)
    assert_same_results(ref, got)
    ndps = [r for r in got if r.is_ndp]
    assert len(ndps) == 3
    assert all(r.ndp_chan.shape == (2, 2, 64) for r in ndps)
    assert np.abs(ndps[0].ndp_chan - ndps[1].ndp_chan).max() < 0.05


@pytest.mark.parametrize("user,snr_db,seed", [(0, 32.0, 41), (1, 32.0, 42),
                                              (0, 9.0, 43), (1, 7.0, 44)])
def test_rx_chain_ok_mu_matches(user, snr_db, seed, monkeypatch):
    """Per packet: ok, ltf_idx and valid of ``rx_chain_ok_mu`` equal the
    reference's for each user, at 32 dB and at an SNR where some packets
    fail and the K1/K2 twins decode."""
    rng = np.random.default_rng(seed)
    stream, mu, mpdus = _mu_stream(rng, 6, _h_sta(rng), user, snr_db)
    cfg = _own_cfg(mu, user)
    calls = []
    acs_ref = PVK.acs_sweep_ref
    monkeypatch.setattr(PVK, "acs_sweep_ref",
                        lambda *a: calls.append(1) or acs_ref(*a))
    ref = [np.asarray(x) for x in JRX.rx_chain_ok_mu(
        cfg, from_host(stream[None]), n_total=2, own=user, nrx=1,
        mpdu_len=len(mpdus[user]), max_pkts=16)]
    got = [x.numpy() for x in PRX.rx_chain_ok_mu(
        from_reference(cfg), from_numpy_cf(stream[None], "cpu"), n_total=2,
        own=user, nrx=1, mpdu_len=len(mpdus[user]), max_pkts=16)]
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and np.array_equal(r, g)
    assert got[2].sum() == 6
    assert calls, "the MU payload never reached the ACS twin"
    if snr_db > 30:
        assert got[0].sum() == 6


def _sounded_q(rng, h_sta, receive):
    """NDP -> each station's channel estimate -> feedback rows -> ZF Q grid;
    ``receive(stream)`` returns the NDP's (nrx, nsts, 64) channel."""
    ndp = gtx.tx_waveform(PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True), b"",
                          group_id=0, partial_aid=0)
    fb = []
    for u in range(2):
        stream = channel.frame_stream(channel.mimo_channel(ndp, h_sta[u]),
                                      1.0, 150.0, gap=1200)
        stream = channel.awgn(stream, 0.015 / 10 ** (35 / 20), rng)
        fb.append(sounding.feedback_from_ndp(receive(stream))[0])
    return sounding.q_to_grid(sounding.zf_q(np.stack(fb)))


@pytest.mark.parametrize("seed,moved_cfo_hz", [(79, 25.0), (77, 60.0)])
def test_mu_engine_batched_rx(seed, moved_cfo_hz):
    """``RxEngine(mu_pos=u, mu_gid=2)`` decodes each station's stream of a
    sounded, ZF-precoded MU PPDU like the JAX engine, result for result; a
    wrong group id decodes nothing; without ``mu_pos`` both engines skip
    the MU PPDUs alike.  Every field is held as ``assert_same_results``
    holds it.  Seed 77, the reference test's own, puts one packet on an
    LTF near-tie that the metric's last bit decides (the port once
    started it one sample early, CFO 48 Hz away).  The port's metric takes
    XLA:CPU's arithmetic (``frontend._ltf_metric``), so where the host
    computes the reference's metric as measured
    (``ltf_metric_as_measured``) every start is held exactly.  Elsewhere
    the tie may still fall the other way: then one packet may move by at
    most two samples, with its CFO within ``moved_cfo_hz``, and without
    ``mu_pos`` (results not ok) the bytes of the moved failed decode are
    not held."""
    from gr_ieee80211_tpu.gold import rx as grx
    rng = np.random.default_rng(seed)
    h_sta = _h_sta(rng)
    bfq = _sounded_q(rng, h_sta, lambda s: grx.receive(s)[0].ndp_chan)
    mu, ams, mpdus = _mu_frames((b"engine user zero " * 7,
                                 b"ENGINE USER ONE " * 5))
    wave = gtx.tx_waveform_mu(mu, ams, bfq)
    for u, mpdu in enumerate(mpdus):
        stream = channel.frame_stream(channel.mimo_channel(wave, h_sta[u]),
                                      1.0, 150.0, num=3, gap=1200)
        stream = channel.awgn(stream, 0.012 / 10 ** (30 / 20), rng)
        ref = JRX.RxEngine(nrx=1, mu_pos=u, mu_gid=2).process(stream)
        eng = PRX.RxEngine(nrx=1, mu_pos=u, mu_gid=2, device="cpu")
        got = eng.process(stream)
        assert_same_results(ref, got, moved_cfo_hz=moved_cfo_hz)
        assert_same_starts([r.start for r in ref], [r.start for r in got])
        assert len(got) == 3 and all(r.ok and r.mpdus[0] == mpdu
                                     and r.mcs == mu.users[u].mcs
                                     for r in got)
        assert eng._spec_canon is None       # MU traffic arms no speculation
        other = PRX.RxEngine(nrx=1, mu_pos=u, mu_gid=5, device="cpu")
        assert not [r for r in other.process(stream) if r.ok]
        ref = JRX.RxEngine(nrx=1).process(stream)
        got = PRX.RxEngine(nrx=1, device="cpu").process(stream)
        assert_same_results(
            ref, got, exact=EXACT if seed == 79 or ltf_metric_as_measured()
            else tuple(f for f in EXACT if f != "psdu"),
            moved_cfo_hz=moved_cfo_hz)
        assert_same_starts([r.start for r in ref], [r.start for r in got])


def test_sounding_loop_on_the_port():
    """The whole loop on the port's entry points: ``TxEngine.tx`` of an
    NDP -> each station's ``RxEngine.process`` -> ``ndp_chan`` -> feedback
    -> ZF Q -> ``TxEngine.tx_mu`` of packets with different payloads ->
    each station's ``RxEngine(mu_pos=u)`` returns exactly its own MPDUs."""
    rng = np.random.default_rng(55)
    h_sta = _h_sta(rng)
    txe = TxEngine(device="cpu")
    ndp = txe.tx(PP.PhyConfig(PP.Fmt.VHT, 0, 2, 0, ampdu=True), [b""])[0]
    fb = []
    for u in range(2):
        s = PCH.frame_stream(PCH.mimo_channel(ndp, h_sta[u]), 1.0, 150.0,
                             gap=1200)
        s = PCH.awgn(s, 0.015 / 10 ** (35 / 20), rng)
        res = PRX.RxEngine(nrx=1, device="cpu").process(s)
        assert len(res) == 1 and res[0].is_ndp
        fb.append(PSND.feedback_from_ndp(res[0].ndp_chan)[0])
    bfq = PSND.q_to_grid(PSND.zf_q(np.stack(fb)))
    n_pkts = 4
    mpdus = [[PMAC.qos_data_frame(
        bytes(rng.integers(0, 256, n, dtype=np.uint8)), STA[u], AP, STA[u], k)
        for k in range(n_pkts)] for u, n in enumerate((120, 84))]
    ams = [[PMAC.ampdu_aggregate_vht([m]) for m in ms] for ms in mpdus]
    mu = PP.mu_config([PP.PhyConfig(PP.Fmt.VHT, 3, 1, len(ams[0][0]),
                                    ampdu=True),
                       PP.PhyConfig(PP.Fmt.VHT, 2, 1, len(ams[1][0]),
                                    ampdu=True)], group_id=2)
    waves = txe.tx_mu(mu, ams, bfq, seeds=[1, 50, 93, 127])
    for u in range(2):
        parts = [np.zeros(600, complex)]
        for w in waves:
            parts += [PCH.apply_cfo(PCH.mimo_channel(w, h_sta[u])[0], 300.0),
                      np.zeros(600, complex)]
        s = PCH.awgn(np.concatenate(parts), 0.012 / 10 ** (30 / 20), rng)
        res = PRX.RxEngine(nrx=1, mu_pos=u, mu_gid=2, device="cpu").process(s)
        assert [r.mpdus for r in res if r.ok] == [[m] for m in mpdus[u]]


def test_mu_closed_loop_on_the_port_gold():
    """``tests/test_mu_loop.py::test_mu_closed_loop`` on the port's numpy
    copies: sounding, raw-H feedback, ZF, per-user gold decode."""
    rng = np.random.default_rng(42)
    h_sta = _h_sta(rng)
    ndp = PGTX.tx_waveform(PP.PhyConfig(PP.Fmt.VHT, 0, 2, 0, ampdu=True), b"",
                           group_id=0, partial_aid=0)
    fb = []
    for u in range(2):
        s = PCH.frame_stream(PCH.mimo_channel(ndp, h_sta[u]), 1.0,
                             200.0 + 100 * u, gap=1200)
        p = PGRX.receive(PCH.awgn(s, 0.015 / 10 ** (35 / 20), rng))[0]
        assert p.is_ndp
        fb.append(PSND.feedback_from_ndp(p.ndp_chan)[0])
    bfq = PSND.q_to_grid(PSND.zf_q(np.stack(fb)))
    mu, ams, mpdus = _mu_frames()
    wave = PGTX.tx_waveform_mu(from_reference(mu), ams, bfq)
    for u, mpdu in enumerate(mpdus):
        s = PCH.frame_stream(PCH.mimo_channel(wave, h_sta[u]), 1.0, 150.0,
                             gap=1200)
        p = PGRX.receive(PCH.awgn(s, 0.012 / 10 ** (30 / 20), rng),
                         mu_pos=u)[0]
        assert p.ok and p.mu and p.mpdus[0] == mpdu


def test_mu_closed_loop_compressed_feedback_on_the_port_gold():
    """``test_mu_closed_loop_compressed_feedback`` on the port's numpy
    copies: the stations feed back Givens-compressed V in VHT action
    frames, the AP parses them, computes ZF Q from the V rows (separation
    within 1 dB of the raw-H loop at 30 dB) and both users decode."""
    rng = np.random.default_rng(46)
    h_sta = _h_sta(rng)
    ndp = PGTX.tx_waveform(PP.PhyConfig(PP.Fmt.VHT, 0, 2, 0, ampdu=True), b"",
                           group_id=0, partial_aid=0)
    frames, fb_raw = [], []
    for u in range(2):
        s = PCH.frame_stream(PCH.mimo_channel(ndp, h_sta[u]), 1.0,
                             200.0 + 100 * u, gap=1200)
        p = PGRX.receive(PCH.awgn(s, 0.015 / 10 ** (35 / 20), rng))[0]
        assert p.is_ndp
        row = PSND.feedback_from_ndp(p.ndp_chan)[0]            # (2, 56)
        fb_raw.append(row)
        v56 = (row.conj() / np.linalg.norm(row, axis=0, keepdims=True)
               ).T[:, :, None]                                  # (56, 2, 1)
        body = PSND.mgmt_vht_bf_body(v56, [p.snr_db], group=1, codebook=1,
                                     token=u + 1)
        frames.append(PMAC.action_no_ack(AP, f"02:00:00:00:00:1{u}", AP,
                                         10 + u, 21, body))
    v_rows = []
    for u, fr in enumerate(frames):
        assert "beamforming" in PMAC.describe_frame(fr)
        rep = PSND.parse_mgmt_vht_bf(fr[24:-4][1:])   # strip hdr, FCS, cat
        assert rep["nc"] == 1 and rep["nr"] == 2 and rep["token"] == u + 1
        v_rows.append(rep["v56"][:, :, 0].conj().T)
    q_c = PSND.zf_q(np.stack(v_rows))
    q_r = PSND.zf_q(np.stack(fb_raw))
    h_true = np.stack(fb_raw)
    snr_lin = 10 ** (30 / 10)
    sinr = {}
    for name, q in (("compressed", q_c), ("raw", q_r)):
        hq = np.einsum("utk,ktj->kuj", h_true, q)
        sinr[name] = []
        for u in range(2):
            sig = np.mean(np.abs(hq[:, u, u]) ** 2)
            leak = np.mean(np.abs(hq[:, u, 1 - u]) ** 2)
            sinr[name].append(10 * np.log10(sig / (leak + sig / snr_lin)))
    for u in range(2):
        assert sinr["raw"][u] - sinr["compressed"][u] < 1.0, sinr
    mu, ams, mpdus = _mu_frames((b"compressed fb u0 " * 7,
                                 b"compressed fb u1 " * 5))
    wave = PGTX.tx_waveform_mu(from_reference(mu), ams, PSND.q_to_grid(q_c))
    for u, mpdu in enumerate(mpdus):
        s = PCH.frame_stream(PCH.mimo_channel(wave, h_sta[u]), 1.0, 150.0,
                             gap=1200)
        p = PGRX.receive(PCH.awgn(s, 0.012 / 10 ** (30 / 20), rng),
                         mu_pos=u)[0]
        assert p.ok and p.mu and p.mpdus[0] == mpdu
