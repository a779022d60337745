"""The port's own numpy layers (``spec``, ``gold``, ``runtime.native``) vs
the JAX package's, which they were copied from: every table, every
derived config field, bits, bytes and samples exactly equal
(``np.array_equal``; no tolerance, the code is the same numpy), and
``from_reference`` carries a config across.
"""
import dataclasses
import inspect

import numpy as np
import pytest

from gr_ieee80211_tpu.gold import bits as JB, channel as JCH, mac as JMAC
from gr_ieee80211_tpu.gold import sig as JS, tx as JTX
from gr_ieee80211_tpu.runtime import native as JNAT
from gr_ieee80211_tpu.spec import params as JP, tables as JT
from gr_ieee80211_tpu_torch.gold import bits as PB, channel as PCH, mac as PMAC
from gr_ieee80211_tpu_torch.gold import sig as PS, tx as PTX
from gr_ieee80211_tpu_torch.runtime import native as PNAT
from gr_ieee80211_tpu_torch.spec import params as PP, tables as PT
from gr_ieee80211_tpu_torch.spec.params import from_reference

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
                         (JCH, PCH), (JP, PP)):
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
