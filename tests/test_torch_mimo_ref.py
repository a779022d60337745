"""The port's two-antenna receive path held to the plain reference of the
benchmark's 2x2 cell (``benchmark/reference/mimo_rx.py``: plain PyTorch in
float64), at small sizes on the CPU, on seeded random packets through
flat 2x2 channels I + 0.25 (N + jN): the P-matrix estimate, the ZF solve
and demap, the deinterleave / deparse, and the decoded PSDUs of
``_payload_core(nrx=2)`` and ``RxEngine(nrx=2)``.  The reference's own
decode of the reference transmitter's packets, and that it imports
nothing of either package, are held here too."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import generate, generate_2x2
from benchmark.entries import rx_engine_blocks as E
from benchmark.reference import mac, mimo_rx as MRX, tx
from benchmark.reference.params import Fmt as RFmt, PhyConfig as RCfg
from benchmark.run import ROOT
from benchmark.tests.cell_small_2x2 import small_cell
from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.ops import ofdm as OF
from gr_ieee80211_tpu_torch.ops.cplx import CF, cstack, from_numpy_cf
from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig

#: the sample of a packet's start where the program's sync puts its L-LTF
#: index: L-STF 160 and GI2 32, less a few samples into the guard interval
LTF_AT = 160 + 32 - 4
#: every two-stream MCS; then one-stream packets, through MRC
TWO = [(RFmt.HT, m, 2) for m in range(8, 16)] + \
    [(RFmt.VHT, m, 2) for m in range(9)]
ONE = [(RFmt.L, 0, 1), (RFmt.L, 5, 1), (RFmt.HT, 3, 1), (RFmt.HT, 7, 1),
       (RFmt.VHT, 2, 1), (RFmt.VHT, 8, 1)]
#: (format, MCS) of each nbpscs, two streams: HT 1, 2, 4, 6; VHT 1 .. 8
BY_NBPSCS = [(RFmt.HT, 8), (RFmt.HT, 9), (RFmt.HT, 11), (RFmt.HT, 13),
             (RFmt.VHT, 0), (RFmt.VHT, 1), (RFmt.VHT, 3), (RFmt.VHT, 5),
             (RFmt.VHT, 8)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: these are many small operations, which several
    threads a test worker only slow down where workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _name(c) -> str:
    return f"{c[0].name}{c[1]}x{c[2]}" if len(c) == 3 else f"{c[0].name}{c[1]}"


def _port(cfg: RCfg) -> PhyConfig:
    return PhyConfig(Fmt(int(cfg.fmt)), cfg.mcs, cfg.nss, cfg.length,
                     ampdu=cfg.ampdu)


def _packets(case, n: int, seed: int, snr_db: float | None, n_bytes=200):
    """``n`` packets of one transmit vector, each through its own 2x2
    channel, laid one after another in a (2, N) complex64 view with 400
    silent samples before each: (view, transmit vector, [PSDU sent],
    [L-LTF index])."""
    fmt, mcs, nss = case
    rng = np.random.default_rng(seed)
    waves, psdus, starts, pos = [], [], [], 400
    for _ in range(n):
        pl = rng.integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
        psdu, agg = generate._psdu(fmt, [mac.qos_data_frame(
            pl, *generate.ADDR, 0)])
        cfg = RCfg(fmt, mcs, nss, len(psdu), ampdu=agg)
        kw = {"group_id": 0, "partial_aid": 0} if fmt == RFmt.VHT else {}
        w = generate_2x2.channel(rng, 0.25)[:, :nss] @ tx.tx_waveform(
            cfg, psdu, **kw)
        waves.append((pos, w / np.sqrt(np.mean(np.abs(w) ** 2))))
        psdus.append(psdu)
        starts.append(pos + LTF_AT)
        pos += w.shape[1] + 400
    view = np.zeros((2, pos), np.complex128)
    for p, w in waves:
        view[:, p: p + w.shape[1]] += w
    if snr_db is not None:
        amp = 10 ** (-snr_db / 20) / np.sqrt(2)
        view += amp * (rng.standard_normal(view.shape)
                       + 1j * rng.standard_normal(view.shape))
    return view.astype(np.complex64), cfg, psdus, starts


def _windows(view, starts, cfg):
    """The same derotated windows for both: float32 CF (B, 2, n) for the
    port, their exact complex128 values for the reference."""
    n = MRX.n_need(cfg)
    x = np.stack([view[:, s: s + n] for s in starts])
    return (from_numpy_cf(x, "cpu"),
            torch.as_tensor(x.astype(np.complex128)))


def _c128(x: CF) -> torch.Tensor:
    return torch.complex(x.re.double(), x.im.double())


@pytest.mark.parametrize("fmt", [RFmt.HT, RFmt.VHT], ids=lambda f: f.name)
@pytest.mark.parametrize("seed", [1, 2])
def test_nl_chanest_2x2_matches_the_reference(fmt, seed):
    """The (B, 2, 2, 64) P-matrix estimate and the pilot channel, the same
    windows in: float32 against float64 on unit-power samples, within
    2e-6 of the largest gain (a few float32 roundings of the DFT)."""
    mcs = 12 if fmt == RFmt.HT else 4
    view, cfg, _, starts = _packets((fmt, mcs, 2), 3, seed, 25.0)
    xs, x128 = _windows(view, starts, cfg)
    h, pilot_h = OF.nl_chanest(xs, MRX.NL_LTF, cfg.nltf, 2)
    hr, phr = MRX.chanest(x128, cfg)
    scale = hr.abs().max().item()
    assert (_c128(h) - hr).abs().max().item() < 2e-6 * scale
    if fmt == RFmt.HT:
        # the engine's HT pilot channel: the streams' estimates summed
        pilot_h = OF.csum(h[:, :, :, OF._idx("PILOT_IDX", "cpu")], dim=2)
    assert (_c128(pilot_h) - phr).abs().max().item() < 2e-6 * scale


@pytest.mark.parametrize("case", BY_NBPSCS, ids=_name)
def test_zf_and_demap_match_the_reference(case):
    """The pilot phase correction, ZF solve and demap of
    ``equalize_and_demap`` against the reference's on the same grids and
    estimates.  Float32 keeps within 1e-4 of the reference's rms (a 2x2
    inverse of float32 Gram entries, channels with condition numbers up
    to ~10); the same solve in bfloat16 misses that by far (its 8-bit
    mantissa: ~1e-2), so the tolerance tells the two apart."""
    fmt, mcs = case
    view, cfg, _, starts = _packets((fmt, mcs, 2), 3, 7 + mcs, 25.0)
    xs, x128 = _windows(view, starts, cfg)
    h, pilot_h = OF.nl_chanest(xs, MRX.NL_LTF, cfg.nltf, 2)
    grids = OF.fft_syms(cstack([
        OF.extract_sym_windows(xs[:, r], MRX.data_start(cfg), cfg.nsym)
        for r in range(2)], dim=1))
    llr = OF.equalize_and_demap(grids, h, pilot_h, _port(cfg))
    g128 = _c128(grids)
    pc = MRX.phase_corrected(g128, _c128(h), _c128(pilot_h), cfg)
    di = MRX.data_idx(cfg)
    eq_ref = MRX.equalize(pc[..., di], _c128(h)[..., di])
    llr_ref = MRX.demap(eq_ref, cfg.nbpscs).reshape(3, 2, -1)
    rms = llr_ref.pow(2).mean().sqrt().item()
    assert (llr.double() - llr_ref).abs().max().item() < 1e-4 * rms
    # the solve alone, on the reference's corrected tones, and in bfloat16
    y = CF(pc.real[..., di].float(), pc.imag[..., di].float())
    hd = h[:, :, :, OF._idx("DATA_IDX_NL", "cpu")]
    eq = OF.zf_equalize(y, hd)
    e_rms = eq_ref.abs().pow(2).mean().sqrt().item()
    assert (_c128(eq) - eq_ref).abs().max().item() < 1e-4 * e_rms
    bf = lambda c: CF(c.re.bfloat16(), c.im.bfloat16())
    eq_bf = OF.zf_equalize(bf(y), bf(hd))
    assert (_c128(eq_bf) - eq_ref).abs().max().item() > 1e-3 * e_rms


@pytest.mark.parametrize("case", BY_NBPSCS, ids=_name)
def test_deinterleave_deparse_2ss_is_the_standards(case):
    """Both streams' deinterleave (with the second stream's frequency
    rotation) and the stream deparser: the same LLRs land in the same
    places, exactly."""
    fmt, mcs = case
    cfg = RCfg(fmt, mcs, 2, 500, ampdu=fmt == RFmt.VHT)
    rng = np.random.default_rng(mcs)
    llr = torch.as_tensor(rng.standard_normal(
        (2, 2, cfg.nsym * cfg.ncbpss)).astype(np.float32))
    got = OF.deinterleave_deparse(llr, _port(cfg))
    ref = MRX.coded_llrs(llr.double().reshape(2, 2, cfg.nsym, -1), cfg)
    assert torch.equal(got.double(), ref)


@pytest.mark.parametrize("case", TWO + ONE, ids=_name)
def test_payload_core_2x2_decodes_as_the_reference(case):
    """``_payload_core(nrx=2)`` (ZF for two streams, MRC for one) and the
    reference decode the same PSDUs, the ones sent, from two packets at
    30 dB at the same sync."""
    view, cfg, psdus, starts = _packets(case, 2, 100 + case[1], 30.0)
    stream = from_numpy_cf(view, "cpu")
    out = PRX._payload_core(_port(cfg), stream,
                            torch.tensor(starts), torch.zeros(2), nrx=2)
    ref = MRX.decode_at([view, view], starts, [0.0, 0.0], cfg)
    for j in range(2):
        got = out["psdu"][j].numpy().tobytes()
        assert got == ref["psdu"][j]
        assert got[: cfg.length] == psdus[j]


@pytest.mark.parametrize("case", TWO + ONE, ids=_name)
def test_reference_decodes_the_transmitters_packets(case):
    """Noise-free, through the channel, the reference gets back every
    PSDU ``reference/tx.py`` sent, at a sync anywhere in the guard
    interval."""
    view, cfg, psdus, starts = _packets(case, 2, 200 + case[1], None,
                                        n_bytes=120)
    ref = MRX.decode_at([view, view], [starts[0], starts[1] - 6],
                        [0.0, 0.0], cfg)
    assert [p[: cfg.length] for p in ref["psdu"]] == psdus


@pytest.fixture(scope="module")
def engine_pass():
    """The small two-antenna cell's blocks through ``RxEngine(nrx=2)`` on
    the CPU, as the benchmark's entry drives it."""
    class Serial:
        def map(self, f, items, chunksize=1):
            return list(map(f, items))
    _, _, cfg, tr = small_cell(ndp_share=0.1)
    inp = generate_2x2.make(tr, cfg, 2**31 + 15, Serial())
    eng = PRX.RxEngine(nrx=2, device="cpu", **cfg["engine"])
    res = [eng.finish_process(eng.begin_process(v)) for v in inp["views"]]
    return inp, res


@pytest.mark.parametrize("k", range(3))
def test_rx_engine_2x2_block_decodes_as_the_reference(engine_pass, k):
    """Each data packet of a two-row block: the engine's PSDU is the one
    sent and the reference's at the engine's own start and CFO."""
    inp, res = engine_pass
    sent = inp["sent"][k]
    got = E._pair([E.as_fields(r) | {"psdu": r.psdu} for r in res[k]],
                  np.array([s for s, _ in sent]))
    n = 0
    for j, (_, f) in enumerate(sent):
        if f["is_ndp"]:
            continue
        (r,) = got[j]
        cfg = RCfg(RFmt(f["fmt"]), f["mcs"], f["nss"], f["length"],
                   ampdu=f["ampdu"])
        ref = MRX.decode_at([inp["views"][k]], [r["start"]], [r["cfo_hz"]],
                            cfg)
        assert r["ok"] and r["mpdus"] == f["mpdus"]
        assert r["psdu"][: cfg.length] == ref["psdu"][0][: cfg.length]
        n += 1
    assert n >= 3


def test_the_engine_pass_covers_both_equalizers(engine_pass):
    inp, _ = engine_pass
    kinds = {(f["nss"], f["is_ndp"]) for sent in inp["sent"]
             for _, f in sent}
    assert {(1, False), (2, False), (2, True)} <= kinds


def test_mimo_reference_imports_nothing_of_either_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.mimo_rx, "
            "benchmark.entries.rx_engine_blocks_2x2; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gr_ieee80211_tpu', "
            "'gr_ieee80211_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
