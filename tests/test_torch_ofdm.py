"""Complex helpers, OFDM demod and the decode tail: the port vs the JAX
package on the same inputs.

Tolerances: exact for index/bit outputs (deinterleave, descramble, bytes,
FCS flags, bf16 staging); float outputs are held to 1e-5 of their scale
(DFT grids) or 1e-4 (channel estimates, LLRs), the float32 rounding left
by summing in another order than XLA (the port's DFT is taken in float64
and rounded once, the reference's in float32).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gr_ieee80211_tpu.gold import channel, mac, tx as gtx
from gr_ieee80211_tpu.ops import cplx as JC
from gr_ieee80211_tpu.ops import crc as JCRC
from gr_ieee80211_tpu.ops import ofdm as JOF
from gr_ieee80211_tpu.spec import tables as T
from gr_ieee80211_tpu.spec.params import Fmt, PhyConfig
from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.ops import cplx as PC
from gr_ieee80211_tpu_torch.ops import crc as PCRC
from gr_ieee80211_tpu_torch.ops import ofdm as POF
from gr_ieee80211_tpu_torch.spec.params import Fmt as PFmt, from_reference

torch.set_num_threads(2)


def _jcf(x: np.ndarray) -> JC.CF:
    return JC.CF(jnp.asarray(x.real.astype(np.float32)),
                 jnp.asarray(x.imag.astype(np.float32)))


def _pcf(x: np.ndarray) -> PC.CF:
    return PC.from_numpy_cf(x, "cpu")


def _np(cf) -> np.ndarray:
    if isinstance(cf, np.ndarray):
        return cf
    if isinstance(cf, PC.CF):
        return PC.to_numpy(cf)
    return np.asarray(cf.re) + 1j * np.asarray(cf.im)


def _close(j, p, rel):
    j, p = _np(j), _np(p)
    assert j.shape == p.shape
    scale = max(float(np.abs(j).max()), 1e-12)
    err = float(np.abs(j - p).max())
    assert err <= rel * scale, (err, scale)


def test_dft64_matches():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(7, 3, 64)) + 1j * rng.normal(size=(7, 3, 64)))
    _close(JC.dft64(_jcf(x)), PC.dft64(_pcf(x)), 1e-5)
    _close(JC.idft64(_jcf(x)), PC.idft64(_pcf(x)), 1e-5)
    # the fftshifted grid convention
    g = np.fft.fftshift(np.fft.fft(x, axis=-1), axes=-1)
    _close(g, PC.dft64(_pcf(x)), 1e-5)


def test_host_ingest_and_helpers():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 300)) + 1j * rng.normal(size=(2, 300))
         ).astype(np.complex64)
    p = PC.from_numpy_cf(x, "cpu")
    assert p.re.dtype == torch.float32 and np.array_equal(PC.to_numpy(p), x)
    jb = JC.from_host_bf16(x)
    pb = PC.from_numpy_cf_bf16(x, "cpu")
    assert pb.re.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(jb.re).astype(np.float32),
                          pb.re.float().numpy())
    assert np.array_equal(np.asarray(jb.im).astype(np.float32),
                          pb.im.float().numpy())
    back = PC.cf_from_pair(np.asarray(jb.re), np.asarray(jb.im), "cpu")
    assert back.re.dtype == torch.bfloat16 and torch.equal(back.re, pb.re)
    th = rng.normal(size=(5, 9)).astype(np.float32)
    _close(JC.expj(jnp.asarray(th)), PC.expj(torch.from_numpy(th)), 1e-6)
    _close(JC.csum(_jcf(x), axis=1), PC.csum(_pcf(x), dim=1), 1e-6)
    a, b = _jcf(x), _jcf(x[::-1])
    pa, pb2 = _pcf(x), _pcf(np.ascontiguousarray(x[::-1]))
    _close(a / b, pa / pb2, 1e-6)
    _close(a.mul_conj(b), pa.mul_conj(pb2), 1e-6)
    _close(a.unit(), pa.unit(), 1e-6)


def _windows(fmt, mcs, B=6, snr=25.0, seed=3):
    """(cfg, xs (B, n) complex): noisy packets cut 3 samples early at the
    L-LTF window (the chain's ltf_idx origin)."""
    rng = np.random.default_rng(seed)
    mpdu = mac.qos_data_frame(bytes(rng.integers(0, 256, 150,
                                                 dtype=np.uint8)),
                              "02:00:00:00:00:01", "02:00:00:00:00:02",
                              "02:00:00:00:00:01", 1)
    if fmt == Fmt.VHT:
        psdu = mac.ampdu_aggregate_vht([mpdu])
        cfg = PhyConfig(fmt, mcs, 1, len(psdu), ampdu=True)
        wave = gtx.tx_waveform(cfg, psdu, group_id=0, partial_aid=0)[0]
    else:
        cfg = PhyConfig(fmt, mcs, 1, len(mpdu))
        wave = gtx.tx_waveform(cfg, mpdu)[0]
    n = PRX._data_start(from_reference(cfg)) + 80 * cfg.nsym + 16
    wave = np.concatenate([wave, np.zeros(n + 200, complex)])
    rms = np.sqrt(np.mean(np.abs(wave[:cfg.n_samples]) ** 2))
    xs = np.stack([wave[189: 189 + n]] * B)
    xs = channel.awgn(xs, rms / 10 ** (snr / 20), rng)
    return cfg, xs


@pytest.mark.parametrize("fmt,mcs", [(Fmt.VHT, 4), (Fmt.HT, 3), (Fmt.L, 5)])
def test_demod_matches(fmt, mcs):
    """Chanest (legacy / NL), the SISO refinement, symbol windows + DFT,
    the dd refinement, equalize + demap and deinterleave vs the JAX ops."""
    cfg, xs = _windows(fmt, mcs)
    jx, px = _jcf(xs), _pcf(xs)
    ds = PRX._data_start(from_reference(cfg))
    _close(JOF.legacy_chanest(jx, 0), POF.legacy_chanest(px, 0), 1e-5)
    if fmt == Fmt.L:
        h0j, h0p = JOF.legacy_chanest(jx, 0), POF.legacy_chanest(px, 0)
        hj, hp = h0j[:, None, None, :], h0p[:, None, None, :]
        pj = h0j[:, T.PILOT_IDX][:, None, :]
        pp = POF.CF(h0p.re[:, T.PILOT_IDX], h0p.im[:, T.PILOT_IDX])[:, None]
    else:
        hj, pj = JOF.nl_chanest(jx[:, None], 448, cfg.nltf, 1, nrx_axis=True)
        hp, pp = POF.nl_chanest(px[:, None], 448, cfg.nltf, 1)
        _close(hj, hp, 1e-5)
        _close(pj, pp, 1e-5)
        sigb = ds - 80 if fmt == Fmt.VHT else None
        hj, pj = JOF.refine_chanest_siso(jx[:, None], hj, pj, fmt=fmt,
                                         sigb_gi=sigb)
        hp, pp = POF.refine_chanest_siso(px[:, None], hp, pp, fmt=PFmt(fmt),
                                         sigb_gi=sigb)
        _close(hj, hp, 1e-4)
        _close(pj, pp, 1e-4)
    gj = JOF.fft_syms(JOF.extract_sym_windows(jx, ds, cfg.nsym))[:, None]
    gp = POF.fft_syms(POF.extract_sym_windows(px, ds, cfg.nsym))[:, None]
    _close(gj, gp, 1e-5)
    hj2, pj2 = JOF.refine_chanest_data(gj, hj, pj, cfg)
    hp2, pp2 = POF.refine_chanest_data(gp, hp, pp, from_reference(cfg))
    _close(hj2, hp2, 1e-4)
    _close(pj2, pp2, 1e-4)
    lj = np.array(JOF.equalize_and_demap(gj, hj2, pj2, cfg, nrx_axis=True))
    lp = POF.equalize_and_demap(gp, hp2, pp2,
                                from_reference(cfg)).numpy()
    assert lj.shape == lp.shape
    assert np.abs(lj - lp).max() <= 1e-4 * np.abs(lj).max()
    assert np.array_equal(np.asarray(JOF.deinterleave_deparse(
        jnp.asarray(lj), cfg)), POF.deinterleave_deparse(
        torch.from_numpy(lj), from_reference(cfg)).numpy())


def test_extract_windows_gather_branch():
    """Windows shorter than the reshape span take the index-gather branch."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 400)) + 1j * rng.normal(size=(3, 400))
    _close(JOF.extract_sym_windows(_jcf(x), 0, 5),
           POF.extract_sym_windows(_pcf(x), 0, 5), 0)


@pytest.mark.parametrize("nbpscs", [1, 2, 4, 6, 8])
def test_llr_demap_matches(nbpscs):
    rng = np.random.default_rng(nbpscs)
    eq = (rng.normal(size=(3, 2, 52)) + 1j * rng.normal(size=(3, 2, 52)))
    ref = np.asarray(JOF.llr_demap(_jcf(eq), nbpscs))
    got = POF.llr_demap(_pcf(eq), nbpscs).numpy()
    assert np.array_equal(ref, got)


def test_equalize_rejects_unported_branches():
    """What the reference cannot equalize, the port rejects too: a legacy
    (1-stream, 1-estimate) channel against 2 receive antennas has no
    broadcast in the normal equations (the reference fails at trace
    time)."""
    cfg = PhyConfig(Fmt.L, 4, 1, 300)
    g = _pcf(np.ones((2, 2, cfg.nsym, 64), complex))
    h = _pcf(np.ones((2, 1, 1, 64), complex))
    p = _pcf(np.ones((2, 1, 4), complex))
    with pytest.raises(RuntimeError):
        POF.equalize_and_demap(g, h, p, from_reference(cfg))


@pytest.mark.parametrize("fmt,mcs,nss,nrx", [
    (Fmt.VHT, 5, 2, 2), (Fmt.HT, 12, 2, 2), (Fmt.HT, 3, 1, 2),
    (Fmt.VHT, 7, 1, 2)])
def test_zf_equalize_matches(fmt, mcs, nss, nrx):
    """ZF / MRC through the normal equations (nrx, nss <= 2), including
    the HT 2-SS per-stream pilot expectation: LLRs within 1e-4 of their
    scale (float32 sums in another order), deinterleaved order exact."""
    rng = np.random.default_rng(mcs + 10 * nss)
    cfg = PhyConfig(fmt, mcs, nss, 400, ampdu=fmt == Fmt.VHT)
    B = 5
    h = (rng.normal(size=(B, nrx, nss, 64))
         + 1j * rng.normal(size=(B, nrx, nss, 64))) / np.sqrt(2)
    x = (rng.normal(size=(B, nrx, cfg.nsym, 64))
         + 1j * rng.normal(size=(B, nrx, cfg.nsym, 64)))
    ph = (rng.normal(size=(B, nrx, 4)) + 1j * rng.normal(size=(B, nrx, 4)))
    ref = np.asarray(JOF.equalize_and_demap(_jcf(x), _jcf(h), _jcf(ph), cfg,
                                            nrx_axis=True))
    got = POF.equalize_and_demap(_pcf(x), _pcf(h), _pcf(ph),
                                 from_reference(cfg)).numpy()
    assert got.shape == ref.shape == (B, nss, cfg.nsym * 52 * cfg.nbpscs)
    assert np.abs(ref - got).max() <= 1e-4 * np.abs(ref).max()
    assert np.array_equal(
        np.asarray(JOF.deinterleave_deparse(jnp.asarray(ref), cfg)),
        POF.deinterleave_deparse(torch.from_numpy(ref),
                                 from_reference(cfg)).numpy())
    xs = (rng.normal(size=(B, nrx, 80 * cfg.nltf))
          + 1j * rng.normal(size=(B, nrx, 80 * cfg.nltf)))
    hj, pj = JOF.nl_chanest(_jcf(xs), 0, cfg.nltf, nss, nrx_axis=True)
    hp, pp = POF.nl_chanest(_pcf(xs), 0, cfg.nltf, nss)
    _close(hj, hp, 1e-5)
    _close(pj, pp, 1e-5)


def test_int8_ingest_and_cstack():
    """Block-AGC int8 staging equals the reference's from_host_i8 exactly;
    cstack stacks (re, im) pairs."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(2, 500)) + 1j * rng.normal(size=(2, 500))) * 0.3
    j = JC.from_host_i8(x)
    p = PC.from_numpy_cf_i8(x, "cpu")
    assert p.re.dtype == torch.float32
    assert np.array_equal(np.asarray(j.re), p.re.numpy())
    assert np.array_equal(np.asarray(j.im), p.im.numpy())
    st = PC.cstack([p[0], p[1]], dim=1)
    assert st.shape == (500, 2) and torch.equal(st.re[:, 1], p.re[1])


def test_decode_tail_matches():
    """descramble -> bytes -> FCS on real frames (some corrupted)."""
    rng = np.random.default_rng(5)
    frames = [mac.qos_data_frame(bytes(rng.integers(0, 256, 90,
                                                    dtype=np.uint8)),
                                 "02:00:00:00:00:01", "02:00:00:00:00:02",
                                 "02:00:00:00:00:01", k) for k in range(6)]
    nbits = 8 * len(frames[0])
    fb = np.stack([T.bytes_to_bits(f) for f in frames]).astype(np.uint8)
    fb[2, 17] ^= 1
    fb[5, -1] ^= 1
    ref_ok = np.asarray(JCRC.fcs_ok_batch(jnp.asarray(fb), nbits))
    got_ok = PCRC.fcs_ok_batch(torch.from_numpy(fb), nbits).numpy()
    assert np.array_equal(ref_ok, got_ok)
    assert got_ok.tolist() == [True, True, False, True, True, False]
    # scrambled bit streams from random seeds; zero SERVICE bits up front
    n = 16 + nbits + 6
    data = np.zeros((6, n), np.uint8)
    data[:, 16: 16 + nbits] = fb
    seeds = rng.integers(1, 128, 6)
    scr = np.stack([data[i] ^ T.scramble_seq(int(s), n)
                    for i, s in enumerate(seeds)]).astype(np.uint8)
    ref = np.asarray(JOF.descramble_bits(jnp.asarray(scr)))
    got = POF.descramble_bits(torch.from_numpy(scr)).numpy()
    assert np.array_equal(ref, got)
    assert np.array_equal(got[:, 16: 16 + nbits], fb)
    jb = np.asarray(JOF.bits_to_bytes_batch(jnp.asarray(got[:, 16: 16 + nbits])))
    pb = POF.bits_to_bytes_batch(torch.from_numpy(got[:, 16: 16 + nbits]))
    assert np.array_equal(jb, pb.numpy())
    assert bytes(pb[0].numpy()) == frames[0]
