"""The port's own numpy layers (``spec``, ``gold``, ``runtime.native``,
the wire format of ``runtime.udp_phy``, ``utils.io``) vs
the JAX package's, which they were copied from: every table, every
derived config field, bits, bytes and samples exactly equal
(``np.array_equal``; no tolerance, the code is the same numpy), and
``from_reference`` carries a config across.
"""
import dataclasses
import inspect
import os

import numpy as np
import pytest

from gr_ieee80211_tpu.gold import bits as JB, channel as JCH, mac as JMAC
from gr_ieee80211_tpu.gold import rx as JRX, sounding as JSND
from gr_ieee80211_tpu.gold import sig as JS, tx as JTX
from gr_ieee80211_tpu.runtime import native as JNAT
from gr_ieee80211_tpu.runtime import udp_phy as JUDP
from gr_ieee80211_tpu.spec import params as JP, tables as JT
from gr_ieee80211_tpu.utils import io as JIO
from gr_ieee80211_tpu_torch.gold import bits as PB, channel as PCH, mac as PMAC
from gr_ieee80211_tpu_torch.gold import rx as PRX, sounding as PSND
from gr_ieee80211_tpu_torch.gold import sig as PS, tx as PTX
from gr_ieee80211_tpu_torch.runtime import native as PNAT
from gr_ieee80211_tpu_torch.runtime import udp_phy as PUDP
from gr_ieee80211_tpu_torch.spec import params as PP, tables as PT
from gr_ieee80211_tpu_torch.spec.params import from_reference
from gr_ieee80211_tpu_torch.utils import io as PIO

ADDR = ("02:00:00:00:00:01", "02:00:00:00:00:02", "02:00:00:00:00:01")


def _same(a, b):
    """Exact equality through tuples, lists, dicts and arrays."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def _public(mod, want_callable):
    return sorted(
        n for n, v in vars(mod).items()
        if not n.startswith("_") and not inspect.ismodule(v)
        and n != "annotations" and callable(v) == want_callable)


TABLE_VALUES = _public(JT, False)

#: every public generator of ``spec.tables`` with the arguments the
#: package calls it with
_BITS = np.random.default_rng(0).integers(0, 2, 34).astype(np.uint8)
TABLE_CALLS = (
    [("bits_to_bytes", (np.tile(_BITS[:8], 5),)),
     ("bytes_to_bits", (bytes(range(40)),)),
     ("crc8_bits", (_BITS,)),
     ("csd_phase", (-200.0,)), ("csd_phase", (-400.0, 20.0)),
     ("lfsr_sequence", (93, 300)), ("scramble_seq", (1,)),
     ("scramble_seq", (127, 500)),
     ("viterbi_acs_tables", ()), ("viterbi_tables", ())]
    + [("interleave_perm_legacy", (n,)) for n in (1, 2, 4, 6)]
    + [("interleave_perm_nl", (n, iss, nss)) for n in (1, 2, 4, 6, 8)
       for nss in (1, 2) for iss in range(nss)]
    + [("qam_table", (n, q)) for n in (1, 2, 4, 6, 8)
       for q in ((False, True) if n == 1 else (False,))]
    + [("stream_parser_perm", (n, 2, 1, 52 * n)) for n in (1, 2, 4, 6, 8)])


def test_tables_have_the_same_names():
    assert _public(PT, False) == TABLE_VALUES
    assert _public(PT, True) == _public(JT, True)
    assert {c[0] for c in TABLE_CALLS} == set(_public(JT, True))
    for mod_j, mod_p in ((JB, PB), (JS, PS), (JMAC, PMAC), (JTX, PTX),
                         (JCH, PCH), (JP, PP), (JRX, PRX), (JSND, PSND)):
        names = set(_public(mod_j, True)) | set(_public(mod_j, False))
        have = set(_public(mod_p, True)) | set(_public(mod_p, False))
        assert names <= have, names - have
    assert "from_reference" in _public(PP, True)


@pytest.mark.parametrize("name", TABLE_VALUES)
def test_table_value_equal(name):
    _same(getattr(JT, name), getattr(PT, name))


@pytest.mark.parametrize("name,args", TABLE_CALLS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(TABLE_CALLS)])
def test_table_function_equal(name, args):
    _same(getattr(JT, name)(*args), getattr(PT, name)(*args))


CONFIGS = ([(0, m, 1) for m in range(8)]
           + [(1, m, m // 8 + 1) for m in range(16)]
           + [(2, m, nss) for m in range(9) for nss in (1, 2)])
_PROPS = [n for n, v in vars(JP.PhyConfig).items() if isinstance(v, property)]


def _cfgs(fmt, mcs, nss, length):
    ampdu = fmt == 2
    return (JP.PhyConfig(JP.Fmt(fmt), mcs, nss, length, ampdu=ampdu),
            PP.PhyConfig(PP.Fmt(fmt), mcs, nss, length, ampdu=ampdu))


@pytest.mark.parametrize("fmt,mcs,nss", CONFIGS)
def test_phyconfig_equal(fmt, mcs, nss):
    """Every derived field over a grid of lengths, NDP and MU padding
    included; ``from_reference`` gives the port's own class with the same
    fields, from the JAX config or from any object with those fields."""
    assert len(_PROPS) >= 20
    assert _PROPS == [n for n, v in vars(PP.PhyConfig).items()
                      if isinstance(v, property)]
    for length in (0, 1, 14, 100, 537, 1500, 4095):
        if length == 0 and fmt != 2:
            continue
        cj, cp = _cfgs(fmt, mcs, nss, length)
        for mu_nsym in (0,) if fmt != 2 else (0, cj.nsym + 3):
            cj2 = dataclasses.replace(cj, mu_nsym=mu_nsym)
            cp2 = dataclasses.replace(cp, mu_nsym=mu_nsym)
            for prop in _PROPS:
                _same(getattr(cj2, prop), getattr(cp2, prop))
            got = from_reference(cj2)
            assert type(got) is PP.PhyConfig and got == cp2
            assert type(got.fmt) is PP.Fmt and hash(got) == hash(cp2)
            assert dataclasses.asdict(got) == dataclasses.asdict(cj2)
            assert from_reference(got) == got


def test_muconfig_from_reference():
    users = [(4, 300), (2, 200)]
    mj = JP.mu_config([JP.PhyConfig(JP.Fmt.VHT, m, 1, n, ampdu=True)
                       for m, n in users], group_id=2)
    mp = from_reference(mj)
    assert type(mp) is PP.MuConfig and mp.group_id == 2
    assert mp == PP.mu_config([PP.PhyConfig(PP.Fmt.VHT, m, 1, n, ampdu=True)
                               for m, n in users], group_id=2)
    for prop in ("nss_total", "nsym", "nltf", "tx_time_us", "legacy_len",
                 "n_samples"):
        assert getattr(mj, prop) == getattr(mp, prop)
    assert mp.user_padded(1) == from_reference(mj.user_padded(1))
    _same(JS.vhtsiga_bits(mj, 2), PS.vhtsiga_bits(mp, 2))
    for u in range(2):
        _same(JS.vhtsigb_bits_mu(mj.users[u]), PS.vhtsigb_bits_mu(mp.users[u]))


def _payload(rng, cfg_fmt, n):
    mpdu = JMAC.qos_data_frame(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                               *ADDR, 5)
    return JMAC.ampdu_aggregate_vht([mpdu]) if cfg_fmt == 2 else mpdu


@pytest.mark.parametrize("fmt,mcs,nss", CONFIGS)
def test_tx_waveform_and_sig_equal(fmt, mcs, nss):
    """SIG bits, the data-field bit pipeline and the whole waveform of a
    seeded packet: sample-equal."""
    rng = np.random.default_rng(100 * fmt + 10 * mcs + nss)
    psdu = _payload(rng, fmt, int(rng.integers(30, 200)))
    cj, cp = _cfgs(fmt, mcs, nss, len(psdu))
    _same(JS.lsig_bits(cj), PS.lsig_bits(cp))
    if fmt == 1:
        _same(JS.htsig_bits(cj), PS.htsig_bits(cp))
        assert JS.parse_htsig(JS.htsig_bits(cj)).__dict__ == \
            PS.parse_htsig(PS.htsig_bits(cp)).__dict__
    kw = {}
    if fmt == 2:
        kw = dict(group_id=0, partial_aid=0)
        _same(JS.vhtsiga_bits(cj), PS.vhtsiga_bits(cp))
        _same(JS.vhtsigb_bits(cj), PS.vhtsigb_bits(cp))
    crc = JS.vhtsigb_bits(cj)[1] if fmt == 2 else np.zeros(8, np.uint8)
    bj = JTX.data_field_bits(cj, psdu, crc)
    _same(bj, PTX.data_field_bits(cp, psdu, crc))
    _same(JTX.encode_data_bits(cj, bj), PTX.encode_data_bits(cp, bj))
    _same(JTX.data_pilots(cj.fmt, nss, cj.nsym),
          PTX.data_pilots(cp.fmt, nss, cp.nsym))
    wj = JTX.tx_waveform(cj, psdu, **kw)
    wp = PTX.tx_waveform(cp, psdu, **kw)
    assert wj.shape == (nss, cj.n_samples)
    _same(wj, wp)


def test_ndp_waveform_equal():
    cj, cp = _cfgs(2, 0, 2, 0)
    _same(JTX.tx_waveform(cj, b"", group_id=0, partial_aid=0),
          PTX.tx_waveform(cp, b"", group_id=0, partial_aid=0))


@pytest.mark.parametrize("seed", range(4))
def test_bits_equal(seed):
    """Scramble / descramble, BCC encode and puncture, interleave, stream
    parse, the numpy Viterbi and the FCS on seeded inputs."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, 432).astype(np.uint8)
    s = int(rng.integers(1, 128))
    _same(JB.scramble(bits, s), PB.scramble(bits, s))
    _same(JB.descramble(JB.scramble(bits, s)),
          PB.descramble(PB.scramble(bits, s)))
    _same(JB.bcc_encode(bits), PB.bcc_encode(bits))
    for cr in ("1/2", "2/3", "3/4", "5/6"):
        _same(JB.bcc_encode_punct(bits, cr), PB.bcc_encode_punct(bits, cr))
        llr = rng.normal(size=len(JB.bcc_encode_punct(bits, cr))
                         ).astype(np.float32)
        _same(JB.depuncture_llr(llr, cr, 432), PB.depuncture_llr(llr, cr, 432))
    for nb, legacy in ((1, True), (4, True), (2, False), (6, False)):
        v = rng.integers(0, 2, (48 if legacy else 52) * nb).astype(np.uint8)
        _same(JB.interleave(v, nb, legacy), PB.interleave(v, nb, legacy))
        _same(JB.deinterleave(v, nb, legacy), PB.deinterleave(v, nb, legacy))
    coded = rng.integers(0, 2, 2 * 52 * 4 * 3).astype(np.uint8)
    pj, pp = JB.stream_parse(coded, 4, 2, 3), PB.stream_parse(coded, 4, 2, 3)
    _same(pj, pp)
    _same(JB.stream_deparse(pj, 4, 3), PB.stream_deparse(pp, 4, 3))
    pairs = ((2.0 * JB.bcc_encode(bits[:120]) - 1).reshape(-1, 2)
             + rng.normal(size=(120, 2)) * 0.5).astype(np.float32)
    _same(JB.viterbi_decode(pairs), PB.viterbi_decode(pairs))
    frame = bytes(rng.integers(0, 256, 77, dtype=np.uint8))
    assert JB.fcs32(frame) == PB.fcs32(frame)
    whole = frame + PB.fcs32(frame)
    assert JB.fcs_ok(whole) and PB.fcs_ok(whole)
    assert not PB.fcs_ok(whole[:-1] + b"\0") or whole[-1] == 0


@pytest.mark.parametrize("seed", range(3))
def test_mac_and_deagg_equal(seed, monkeypatch):
    """Framing, HT/VHT aggregation, the delimiter walk (pure Python and
    ``deagg_vht``, native where the library loads) and the frame parsers
    on seeded MPDUs, one of them corrupted."""
    rng = np.random.default_rng(40 + seed)
    pay = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
           for n in rng.integers(20, 400, 4)]
    udp_j = JMAC.llc_ip_udp(pay[0], "10.0.0.1", "10.0.0.2", 9000, 9001)
    assert udp_j == PMAC.llc_ip_udp(pay[0], "10.0.0.1", "10.0.0.2", 9000, 9001)
    mj = [JMAC.qos_data_frame(p, *ADDR, k) for k, p in enumerate(pay)]
    mp = [PMAC.qos_data_frame(p, *ADDR, k) for k, p in enumerate(pay)]
    assert mj == mp
    assert JMAC.data_frame(pay[1], *ADDR, 3) == \
        PMAC.data_frame(pay[1], *ADDR, 3)
    assert JMAC.ndp_announcement(ADDR[0], ADDR[1], 7, [1, 2], [0, 1]) == \
        PMAC.ndp_announcement(ADDR[0], ADDR[1], 7, [1, 2], [0, 1])
    assert JMAC.bf_report_poll(ADDR[0], ADDR[1], [0, 3]) == \
        PMAC.bf_report_poll(ADDR[0], ADDR[1], [0, 3])
    assert JMAC.action_no_ack(*ADDR, 9, 21, pay[3]) == \
        PMAC.action_no_ack(*ADDR, 9, 21, pay[3])
    for agg in ("ampdu_aggregate_ht", "ampdu_aggregate_vht"):
        assert getattr(JMAC, agg)(mj) == getattr(PMAC, agg)(mp)
    am = bytearray(PMAC.ampdu_aggregate_vht(mp))
    am[len(mp[0]) + 10] ^= 0x40          # break the second MPDU's FCS
    am = bytes(am) + bytes(12)
    want = JMAC.ampdu_deaggregate(am)
    assert PMAC.ampdu_deaggregate(am) == want and len(want) == 3
    assert JNAT.deagg_vht(am) == PNAT.deagg_vht(am) == want
    monkeypatch.setattr(PNAT, "_lib", lambda: None)   # the Python fallback
    assert PNAT.deagg_vht(am) == want
    ht = PMAC.ampdu_aggregate_ht(mp)
    assert JMAC.ampdu_deaggregate(ht, ht=True) == \
        PMAC.ampdu_deaggregate(ht, ht=True) == mp
    assert JMAC.parse_frame(mj[2]).__dict__ == PMAC.parse_frame(mp[2]).__dict__
    assert JMAC.describe_frame(mj[2]) == PMAC.describe_frame(mp[2])
    assert JMAC.parse_delimiter(am[:4]).__dict__ == \
        PMAC.parse_delimiter(am[:4]).__dict__


def test_channel_equal():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 700)) + 1j * rng.normal(size=(2, 700)))
    _same(JCH.apply_cfo(x, 1234.5), PCH.apply_cfo(x, 1234.5))
    _same(JCH.frame_stream(x, 0.7, 900.0, num=3, gap=250),
          PCH.frame_stream(x, 0.7, 900.0, num=3, gap=250))
    _same(JCH.awgn(x, 0.1, np.random.default_rng(9)),
          PCH.awgn(x, 0.1, np.random.default_rng(9)))
    h = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    _same(JCH.mimo_channel(x, h), PCH.mimo_channel(x, h))
    taps = (rng.normal(size=(2, 2, 3)) + 1j * rng.normal(size=(2, 2, 3))) / 3
    _same(JCH.multipath_channel(x, taps), PCH.multipath_channel(x, taps))
    assert JCH.noise_amp_for_snr(0.5, 17.0) == PCH.noise_amp_for_snr(0.5, 17.0)
    assert JCH.REF_SIG_AMP == PCH.REF_SIG_AMP


# ---------------------------------------------------------------------------
# gold/sounding.py and gold/rx.py
# ---------------------------------------------------------------------------

def _chan(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)) / np.sqrt(2)


@pytest.mark.parametrize("seed", range(3))
def test_sounding_feedback_and_zf_equal(seed):
    """NDP channel -> feedback rows -> ZF Q -> 64-bin grid, and the pilot
    interpolation alone."""
    rng = np.random.default_rng(60 + seed)
    ndp = _chan(rng, (1, 2, 64))
    fj, fp = JSND.feedback_from_ndp(ndp), PSND.feedback_from_ndp(ndp)
    _same(fj, fp)
    assert fp.shape == (1, 2, 56)
    h52 = _chan(rng, (2, 52))
    _same(JSND.interp_pilot_tones(h52), PSND.interp_pilot_tones(h52))
    rows = np.stack([fp[0], PSND.feedback_from_ndp(_chan(rng, (1, 2, 64)))[0]])
    qj, qp = JSND.zf_q(rows), PSND.zf_q(rows)
    _same(qj, qp)
    _same(JSND.q_to_grid(qj), PSND.q_to_grid(qp))
    assert PSND.q_to_grid(qp).shape == (64, 2, 2)


@pytest.mark.parametrize("m,n,codebook", [(2, 1, 0), (2, 2, 1), (3, 2, 0),
                                          (4, 2, 1)])
def test_sounding_givens_equal(m, n, codebook):
    """Givens compression, decompression, the angle order and the bit
    packing of a seeded unitary V."""
    rng = np.random.default_rng(70 + 10 * m + n)
    u, _, _ = np.linalg.svd(_chan(rng, (m, n)), full_matrices=False)
    v = u[:, :n]
    cj, cp = JSND.givens_compress(v, codebook), PSND.givens_compress(v, codebook)
    _same(cj, cp)
    vals, types = cp
    assert JSND.angle_order(m, n) == PSND.angle_order(m, n) == types
    _same(JSND.givens_decompress(vals, types, m, n, codebook),
          PSND.givens_decompress(vals, types, m, n, codebook))
    blob = PSND.pack_bf_report(vals, types, codebook)
    assert blob == JSND.pack_bf_report(vals, types, codebook)
    assert (JSND.unpack_bf_report(blob, types, codebook)
            == PSND.unpack_bf_report(blob, types, codebook) == vals)


@pytest.mark.parametrize("group,codebook", [(1, 0), (1, 1), (2, 1), (4, 0)])
def test_sounding_mgmt_frame_equal(group, codebook):
    """The VHT compressed beamforming action body and its parser."""
    rng = np.random.default_rng(80 + group + codebook)
    row = _chan(rng, (2, 56))
    v56 = (row.conj() / np.linalg.norm(row, axis=0, keepdims=True)
           ).T[:, :, None]
    kw = dict(group=group, codebook=codebook, token=5)
    bj = JSND.mgmt_vht_bf_body(v56, [21.3], **kw)
    bp = PSND.mgmt_vht_bf_body(v56, [21.3], **kw)
    assert bj == bp
    _same(JSND.parse_mgmt_vht_bf(bj), PSND.parse_mgmt_vht_bf(bp))
    assert JSND.BFFB_SCIDX_20 == PSND.BFFB_SCIDX_20


def _mu_waveform(rng, h_sta):
    m0 = PMAC.qos_data_frame(bytes(rng.integers(0, 256, 90, dtype=np.uint8)),
                             *ADDR, 5)
    m1 = PMAC.qos_data_frame(bytes(rng.integers(0, 256, 60, dtype=np.uint8)),
                             *ADDR, 6)
    a0, a1 = PMAC.ampdu_aggregate_vht([m0]), PMAC.ampdu_aggregate_vht([m1])
    mu = PP.mu_config([PP.PhyConfig(PP.Fmt.VHT, 3, 1, len(a0), ampdu=True),
                       PP.PhyConfig(PP.Fmt.VHT, 2, 1, len(a1), ampdu=True)],
                      group_id=2)
    h_rows = np.repeat(np.stack(h_sta)[:, 0][:, :, None], 56, axis=2)
    q = PSND.q_to_grid(PSND.zf_q(h_rows))
    return PTX.tx_waveform_mu(mu, [a0, a1], q), (m0, m1)


def _same_packets(pj, pp):
    assert len(pj) == len(pp)
    for a, b in zip(pj, pp):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.keys() == db.keys()
        for k in da:
            if k == "fmt":
                assert (da[k] is None) == (db[k] is None)
                assert da[k] is None or int(da[k]) == int(db[k])
            elif da[k] is None:
                assert db[k] is None
            else:
                _same(da[k], db[k])


@pytest.mark.parametrize("case", ["legacy", "ht", "vht", "ht2x2", "ndp",
                                  "mu0", "mu1"])
def test_gold_receive_equal(case):
    """``receive`` on a seeded noisy stream of each kind (L, HT, VHT, 2x2
    HT, a 2-stream NDP, an MU PPDU at each station): every field of every
    packet equal, floats and the NDP channel included."""
    rng = np.random.default_rng(sum(map(ord, case)))
    mu_pos = None
    if case in ("mu0", "mu1"):
        mu_pos = int(case[-1])
        h_sta = [_chan(rng, (1, 2)) for _ in range(2)]
        wave, mpdus = _mu_waveform(rng, h_sta)
        wave = PCH.mimo_channel(wave, h_sta[mu_pos])
    elif case == "ndp":
        wave = PCH.mimo_channel(
            PTX.tx_waveform(PP.PhyConfig(PP.Fmt.VHT, 0, 2, 0, ampdu=True),
                            b"", group_id=0, partial_aid=0), _chan(rng, (1, 2)))
    else:
        fmt, mcs, nss = {"legacy": (0, 5, 1), "ht": (1, 3, 1),
                         "vht": (2, 4, 1), "ht2x2": (1, 11, 2)}[case]
        psdu = _payload(rng, fmt, 80)
        _, cp = _cfgs(fmt, mcs, nss, len(psdu))
        kw = dict(group_id=0, partial_aid=0) if fmt == 2 else {}
        wave = PTX.tx_waveform(cp, psdu, **kw)
        if nss == 2:
            wave = PCH.mimo_channel(wave, np.eye(2) + 0.3 * _chan(rng, (2, 2)))
    stream = PCH.frame_stream(wave, 1.0, 230.0, num=2, gap=900)
    stream = PCH.awgn(stream, 0.012 / 10 ** (30 / 20), rng)
    pj = JRX.receive(stream, mu_pos=mu_pos)
    pp = PRX.receive(stream, mu_pos=mu_pos)
    _same_packets(pj, pp)
    assert len(pp) == 2 and all(p.ok for p in pp)
    if mu_pos is not None:
        assert all(p.mu and p.mpdus == [mpdus[mu_pos]] for p in pp)
    if case == "ndp":
        assert all(p.is_ndp and p.ndp_chan.shape == (1, 2, 64) for p in pp)
    assert PRX.receive(stream, mu_pos=mu_pos, max_packets=1)[0].start \
        == pp[0].start


def test_gold_rx_helpers_equal():
    """Every public helper of ``gold.rx`` on seeded inputs."""
    rng = np.random.default_rng(91)
    cp = PP.PhyConfig(PP.Fmt.VHT, 2, 1, 60, ampdu=True)
    wave = PTX.tx_waveform(cp, bytes(60), group_id=0, partial_aid=0)
    x = PCH.awgn(PCH.frame_stream(wave, 1.0, 400.0, gap=600), 1e-3, rng)[0]
    mj, mp = JRX.stf_metric(x), PRX.stf_metric(x)
    _same(mj, mp)
    trig = PRX.find_triggers(mp[0])
    assert trig == JRX.find_triggers(mj[0]) and len(trig) >= 1
    sj, sp = JRX.ltf_sync(x, trig[0] + 80), PRX.ltf_sync(x, trig[0] + 80)
    assert sj == sp and sp is not None
    assert PRX.ltf_sync(x[:100], 0) is None
    li = sp[0]
    c0 = PRX.coarse_cfo(x, trig[0])
    assert c0 == JRX.coarse_cfo(x, trig[0])
    assert JRX.fine_cfo(x, li, c0) == PRX.fine_cfo(x, li, c0)
    _same(JRX.derotate(x, li, 500, 400.0), PRX.derotate(x, li, 500, 400.0))
    _same(JRX.fft_sym(x[li: li + 64]), PRX.fft_sym(x[li: li + 64]))
    _same(JRX.sym_window(x, li + 128), PRX.sym_window(x, li + 128))
    _same(JRX.legacy_chan_est(x, li), PRX.legacy_chan_est(x, li))
    eq = _chan(rng, (3, 52))
    for nb in (1, 2, 4, 6, 8):
        _same(JRX.llr_demap(eq, nb), PRX.llr_demap(eq, nb))
    p, e = _chan(rng, (4,)), _chan(rng, (4,))
    assert JRX.pilot_phase(p, e) == PRX.pilot_phase(p, e)
    assert PRX.pilot_phase(np.zeros(4, complex), e) == 1.0
    grids = _chan(rng, (2, 2, 64))
    _same(JRX.nl_chan_est(grids, 2, JP.Fmt.VHT),
          PRX.nl_chan_est(grids, 2, PP.Fmt.VHT))
    _same(JRX.nl_pilot_chan(grids), PRX.nl_pilot_chan(grids))
    y, h = _chan(rng, (2, 52)), _chan(rng, (2, 2, 52))
    _same(JRX.zf_equalize(y, h), PRX.zf_equalize(y, h))
    _same(JRX.zf_equalize(y[:1], h[:1, :1]), PRX.zf_equalize(y[:1], h[:1, :1]))
    assert [f.name for f in dataclasses.fields(JRX.RxPacket)] == \
        [f.name for f in dataclasses.fields(PRX.RxPacket)]


@pytest.mark.parametrize("nss", [1, 2])
def test_io_equal(nss, tmp_path):
    """``utils.io``: the same files from the same streams (cf32 and the
    openwifi text format), and the same arrays read back."""
    rng = np.random.default_rng(40 + nss)
    sig = (rng.normal(size=(nss, 777)) + 1j * rng.normal(size=(nss, 777))
           ) * 1000.0
    for mod in (JIO, PIO):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        assert [os.path.basename(p) for p in mod.write_streams(
            str(d / "s"), sig.astype(np.complex64))] == \
            [f"s_{nss}x{nss}_{i}.bin" for i in range(nss)]
        mod.write_streams_ow(str(d / "o"), sig)
        mod.write_cf32(str(d / "one.bin"), sig[0])
    jd, pd = tmp_path / "gr_ieee80211_tpu", tmp_path / "gr_ieee80211_tpu_torch"
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in pd.iterdir())
    for n in names:
        assert (jd / n).read_bytes() == (pd / n).read_bytes(), n
        if n.endswith(".bin"):
            _same(PIO.read_cf32(str(pd / n)), JIO.read_cf32(str(jd / n)))
        else:
            _same(PIO.read_streams_ow(str(pd / n)),
                  JIO.read_streams_ow(str(jd / n)))


@pytest.mark.parametrize("seed", range(3))
def test_wire_format_equal(seed):
    """``runtime.udp_phy``'s wire functions on seeded valid requests and
    reports: equal requests, bytes and parses."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(64, 2, 2, 2))).astype(np.float32)
    blobs = [bytes([10]) + q.tobytes(), b"\x02\x00\x02\x00\x00"]
    for fmt, mcs, nss in ((0, int(rng.integers(8)), 1),
                          (1, int(rng.integers(16)), None),
                          (2, int(rng.integers(9)), int(rng.integers(1, 3)))):
        nss = nss or mcs // 8 + 1
        n = int(rng.integers(1, 4096))
        blobs.append(bytes([fmt, mcs, nss, n & 0xFF, n >> 8]) + rng.bytes(n))
    n0, n1 = (int(v) for v in rng.integers(1, 2000, 2))
    blobs.append(bytes([3, 2, 1, n0 & 0xFF, n0 >> 8, 1, 1, n1 & 0xFF,
                        n1 >> 8, 2]) + rng.bytes(n0 + n1))
    for b in blobs:
        j, p = JUDP.parse_mac_to_phy(b), PUDP.parse_mac_to_phy(b)
        assert j.kind == p.kind and j.__dict__.keys() == p.__dict__.keys()
        for k in j.__dict__:
            a, c = getattr(j, k), getattr(p, k)
            if isinstance(a, np.ndarray):
                _same(c, a)
            elif k == "fmt":                # each package's own Fmt enum
                assert int(a) == int(c)
            else:
                _same(c, a)
    chan = rng.normal(size=(2, 64)) + 1j * rng.normal(size=(2, 64))
    for blob in (PUDP.pack_chan_report(chan),
                 PUDP.pack_phy_to_mac(2, rng.bytes(300), 7)):
        assert blob == (JUDP.pack_chan_report(chan) if blob[0] == 20 else
                        JUDP.pack_phy_to_mac(2, blob[3:-1], 7))
        (f0, x0, m0), (f1, x1, m1) = (PUDP.parse_phy_to_mac(blob),
                                      JUDP.parse_phy_to_mac(blob))
        assert (f0, m0) == (f1, m1)
        if isinstance(x0, np.ndarray):
            _same(x0, x1)
        else:
            assert x0 == x1
