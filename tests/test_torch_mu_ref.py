"""The port's MU-MIMO station decode held to the plain reference of the
benchmark's MU station cell (``benchmark/reference/mu_rx.py``: plain
PyTorch in float64), at small sizes on the CPU.

Seeded random PPDUs of group 2 (each user its own MCS 0-8 and A-MPDU of
1-3 MPDUs, each PPDU its own CFO), ZF-precoded from both stations' 30 dB
NDP estimates, at 30 dB, in streams of a few PPDUs through
``RxEngine(nrx=1, mu_pos=u, mu_gid=2, device="cpu")``, at both positions
(``tests/_mu_streams.py``).  The engine's SIG-B bits and PSDUs equal the
reference's at the engine's own start and CFO; its own-stream LLRs (what
``_payload_core_mu`` hands the decoder) lie within 1e-4 of the row's rms
LLR of the reference's; a PPDU altered on purpose is reported once, not
ok; a PPDU of another group never.  The benchmark's copies of the MU
transmitter and sounding equal the port's gold ones."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import generate as G
from benchmark.reference import mac, mu_rx as MURX, tx_mu
from benchmark.reference.params import Fmt as RFmt, MuConfig as RMu
from benchmark.reference.params import PhyConfig as RCfg
from benchmark.run import ROOT
from gr_ieee80211_tpu_torch.gold import mac as PMAC
from gr_ieee80211_tpu_torch.gold import sig as PSIG, sounding as PSND
from gr_ieee80211_tpu_torch.gold import tx as PGTX
from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.ops import ofdm as OF
from gr_ieee80211_tpu_torch.ops.cplx import CF
from gr_ieee80211_tpu_torch.spec import params as PP
from _mu_streams import LTF_AT, mu_stream, pair

#: streams a position, each of three PPDUs of group 2 and one of group 3
SEEDS = (11, 12)
KINDS = ("own", "own", "foreign", "own")
#: LLR tolerance, over the row's rms LLR of the reference: float32 on the
#: same bfloat16-staged samples (the DFTs, pilot phase and one-tap
#: equalize round at ~1e-6 of the row's scale) keeps well inside it; a
#: channel estimate rounded to bfloat16 (an 8-bit mantissa, ~4e-3) moves
#: the LLRs by ~1e-2 of that scale, two orders outside
LLR_REL = 1e-4
LLR_REL_BF16 = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: many small operations, which several threads a
    test worker only slow down where workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tapped(mp):
    """Wrap the MU decode's stages for the context of ``mp``: each SIG-B
    pass's (ltf_idx, bits) and each payload call's config, ltf_idx, the
    demodulation's inputs and its coded-order LLRs."""
    kept = {"sigb": [], "payload": []}
    orig = (PRX._mu_sigb_core, PRX._payload_core_mu, OF.payload_demod)
    cur: list = []

    def sigb(stream, ltf_idx, *a, **k):
        bits = orig[0](stream, ltf_idx, *a, **k)
        kept["sigb"].append((ltf_idx.numpy().copy(), bits.numpy().copy()))
        return bits

    def payload(cfg, stream, ltf_idx, *a, **k):
        cur.append({"cfg": cfg, "ltf_idx": ltf_idx.numpy().copy()})
        try:
            return orig[1](cfg, stream, ltf_idx, *a, **k)
        finally:
            kept["payload"].append(cur.pop())

    def demod(xs, data_start, h, pilot_h, cfg):
        coded = orig[2](xs, data_start, h, pilot_h, cfg)
        if cur:
            cur[-1].update(args=(xs, data_start, h, pilot_h, cfg),
                           coded=coded.numpy().copy())
        return coded
    mp.setattr(PRX, "_mu_sigb_core", sigb)
    mp.setattr(PRX, "_payload_core_mu", payload)
    mp.setattr(OF, "payload_demod", demod)
    return kept


def _decode(pos: int, kinds, seed: int):
    """One stream through a fresh station engine: (sent, results, the
    sent index -> results pairing)."""
    x, sent = mu_stream(pos, seed, kinds)
    eng = PRX.RxEngine(nrx=1, mu_pos=pos, mu_gid=2, device="cpu")
    res = eng.finish_process(eng.begin_process(x[None]))
    return x, sent, res, pair(res, sent)


@pytest.fixture(scope="module", params=[0, 1], ids=["pos0", "pos1"])
def mu_pass(request):
    """Each stream of a position through the engine with the MU decode's
    stages tapped, and the reference's decode of every PPDU of the group
    at the engine's own start and CFO: (pos, [(sent, results, pairing,
    {sent index: reference row}, the stream's taps)])."""
    pos = request.param
    out = []
    for seed in SEEDS:
        with pytest.MonkeyPatch.context() as mp:
            kept = _tapped(mp)
            x, sent, res, got = _decode(pos, KINDS, seed)
        refs = {}
        for j, rs in got.items():
            if sent[j].group == 2:
                (refs[j],) = MURX.decode_at(
                    [x[None]], [rs[0].start], [rs[0].cfo_hz], 2, pos, 1,
                    sent[j].nsym)
        out.append((sent, res, got, refs, kept))
    return pos, out


def _ref_mpdus(ref) -> list:
    return PMAC.ampdu_deaggregate(ref["psdu"]) if ref["cfg"] else []


def test_every_ppdu_of_the_group_is_reported_once_and_no_other(mu_pass):
    """Each PPDU of the group once, with its own user's MCS and one
    stream, ok with every MPDU sent wherever the reference decodes every
    one (at 30 dB through ZF from estimated CSI a 256-QAM PPDU may fail
    on both sides); the other group's PPDU never."""
    _, out = mu_pass
    n_ok = 0
    for sent, res, got, refs, _ in out:
        assert len(res) == sum(s.group == 2 for s in sent)
        for j, s in enumerate(sent):
            if s.group != 2:
                assert j not in got
                continue
            (r,) = got[j]
            assert (r.fmt, r.mcs, r.nss) == (PP.Fmt.VHT, s.mcs, 1)
            if _ref_mpdus(refs[j]) == s.mpdus:
                assert r.ok and r.mpdus == s.mpdus
                n_ok += 1
    assert n_ok >= 2 * len(SEEDS)


def test_sigb_bits_and_psdus_equal_the_references(mu_pass):
    """Bits and bytes: SIG-B and the PSDU wherever the reference's SERVICE
    check and some MPDU's FCS pass."""
    _, out = mu_pass
    n = 0
    for sent, _, got, refs, kept in out:
        sigb = {int(li): b for lis, bits in kept["sigb"]
                for li, b in zip(lis, bits)}
        for j, ref in refs.items():
            if not (_ref_mpdus(ref) and ref["service_ok"]):
                continue
            (r,) = got[j]
            assert np.array_equal(sigb[r.start], ref["sigb"].numpy())
            assert r.psdu == ref["psdu"]
            n += 1
    assert n >= 2 * len(SEEDS)


def test_own_stream_llrs_match_the_references(mu_pass):
    """Each row of each payload call: the coded-order LLRs within LLR_REL
    of the reference's rms; the same demodulation from a bfloat16 channel
    estimate misses by more than LLR_REL_BF16."""
    _, out = mu_pass
    n = 0
    for sent, _, got, rows, kept in out:
        refs = {got[j][0].start: (sent[j], ref) for j, ref in rows.items()}
        for call in kept["payload"]:
            cfg = call["cfg"]
            for b, li in enumerate(call["ltf_idx"]):
                s, ref = refs[int(li)]
                if (s.mcs, s.nsym) != (cfg.mcs, cfg.nsym):
                    continue              # a padded row of another PPDU
                lr = ref["llr"].numpy()
                rms = np.sqrt(np.mean(lr ** 2))
                assert np.abs(call["coded"][b] - lr).max() < LLR_REL * rms
                n += 1
            xs, d0, h, ph, c = call["args"]
            bf = lambda z: CF(z.re.bfloat16().float(),
                              z.im.bfloat16().float())
            coded_bf = OF.payload_demod_ref(xs, d0, bf(h), bf(ph), c)
            s, ref = refs[int(call["ltf_idx"][0])]
            lr = ref["llr"].numpy()
            assert np.abs(coded_bf[0].numpy() - lr).max() > \
                LLR_REL_BF16 * np.sqrt(np.mean(lr ** 2))
    assert n == 3 * len(SEEDS)


@pytest.mark.parametrize("alter", ["sigb_tail", "service", "data"])
def test_an_altered_ppdu_is_reported_once_not_ok(alter):
    """A PPDU of the group whose SIG-B is rejected, whose SERVICE field
    disagrees with its SIG-B, or whose data fails its FCS comes out once,
    not ok, with its own user's MCS and one stream (the JAX package drops
    the first two); the other group's PPDU not at all; the rest ok."""
    _, sent, res, got = _decode(1, ("own", alter, "foreign", "own"), 21)
    assert len(res) == 3 and 2 not in got
    for j in (0, 3):
        assert got[j][0].ok and got[j][0].mpdus == sent[j].mpdus
    (r,) = got[1]
    assert not r.ok and not r.mpdus
    assert (r.fmt, r.mcs, r.nss) == (PP.Fmt.VHT, sent[1].mcs, 1)


@pytest.mark.parametrize("pos", [0, 1])
def test_reference_decodes_the_transmitters_ppdus(pos):
    """At 60 dB, the reference gets back each PPDU's PSDU, its SERVICE
    check passing, at the true CFO and a sync anywhere in the guard
    interval."""
    x, sent = mu_stream(pos, 31, ("own", "own"), snr_db=60.0)
    for s, early in zip(sent, (0, 6)):
        (ref,) = MURX.decode_at([x[None]], [s.start + LTF_AT - early],
                                [s.cfo_hz], 2, pos, 1, s.nsym)
        assert ref["cfg"].mcs == s.mcs and ref["service_ok"]
        assert ref["psdu"][: s.length] == mac.ampdu_aggregate_vht(s.mpdus)


def test_the_benchmarks_mu_copies_are_the_ports():
    """``reference/tx_mu.py``'s SIG-B bits, MU waveform and sounding equal
    the port's ``gold/{sig,tx,sounding}.py`` on the same inputs."""
    rng = np.random.default_rng(5)
    for mcs, length in ((0, 101), (8, 4095), (5, 640)):
        rc = RCfg(RFmt.VHT, mcs, 1, length, ampdu=True)
        pc = PP.PhyConfig(PP.Fmt.VHT, mcs, 1, length, ampdu=True)
        for a, b in zip(tx_mu.vhtsigb_bits_mu(rc), PSIG.vhtsigb_bits_mu(pc)):
            assert np.array_equal(a, b)
    users = [(3, 200, 2), (7, 450, 1)]
    mpdus = [G._mpdus(None, [rng.integers(0, 256, b // m, dtype=np.uint8)
                             .tobytes() for _ in range(m)])
             for _, b, m in users]
    ams = [mac.ampdu_aggregate_vht(m) for m in mpdus]
    rmu = RMu(tuple(RCfg(RFmt.VHT, m, 1, len(a), ampdu=True)
                    for (m, _, _), a in zip(users, ams)), group_id=2)
    pmu = PP.MuConfig(tuple(PP.PhyConfig(PP.Fmt.VHT, m, 1, len(a),
                                         ampdu=True)
                            for (m, _, _), a in zip(users, ams)), group_id=2)
    est = rng.standard_normal((2, 1, 2, 64)) \
        + 1j * rng.standard_normal((2, 1, 2, 64))
    rows_r = np.stack([tx_mu.feedback_from_ndp(e)[0] for e in est])
    rows_p = np.stack([PSND.feedback_from_ndp(e)[0] for e in est])
    assert np.array_equal(rows_r, rows_p)
    q = tx_mu.q_to_grid(tx_mu.zf_q(rows_r))
    assert np.array_equal(q, PSND.q_to_grid(PSND.zf_q(rows_p)))
    assert np.array_equal(tx_mu.tx_waveform_mu(rmu, ams, q),
                          PGTX.tx_waveform_mu(pmu, ams, q))


def test_mu_reference_imports_nothing_of_either_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.mu_rx, benchmark.generate_mu, "
            "benchmark.entries.rx_engine_blocks_mu, benchmark.faults_mu; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gr_ieee80211_tpu', "
            "'gr_ieee80211_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
