"""The payload demodulation's wrapper (``ops/ofdm.payload_demod``, K8 on the
card) on the CPU: CPU tensors take the plain twin, which is the stage as
``models/rx._payload_core`` composed it (symbol windows, DFT,
``equalize_and_demap``, ``deinterleave_deparse``), and launch nothing; the
wrapper refuses what the kernel cannot take; the C source agrees with the
wrapper on its entry point and its constant table; and the kernel's
source, compiled for the CPU with a header that runs one OS thread per
CUDA thread (``tests/cuda_cpu_shim.h``), returns the twin's LLRs over L /
HT / VHT, BPSK to 256-QAM, one and two antennas and streams (HT's
two-stream pilots included), one symbol to several tiles of symbols.

Bit-equal to the twin computed as the card computes it: with a correctly
rounded square root (PyTorch's CPU ``sqrt`` is 1 ulp off for ~0.6% of
float32 inputs, the card's is not, and the pilot phasor's magnitude takes
one) and with the pilot sum in the order of PyTorch's CUDA reduction,
which K8 takes (each pilot's antennas, then (p0 + p2) + (p1 + p3); the
CPU sums each antenna's pilots in turn).  Against the twin as it runs on
the CPU the LLRs lie within ``LLR_REL`` times the row's largest condition
number (1 for one stream; the two-stream ZF magnifies by it) of the row's
largest |LLR|: a float32 rounding of the phasor, carried through the
equalizer.

K8 itself is held to the twin on the card by
``tests/test_torch_payload_demod_card.py``."""
import re

import numpy as np
import pytest
import torch

import _chanest_windows as W
import _cuda_cpu
from gr_ieee80211_tpu_torch.gold.tx import data_pilots
from gr_ieee80211_tpu_torch.models.rx import _data_start
from gr_ieee80211_tpu_torch.ops import cuda_lib as PCL
from gr_ieee80211_tpu_torch.ops import ofdm as OF
from gr_ieee80211_tpu_torch.ops.cplx import CF, cstack
from gr_ieee80211_tpu_torch.spec import tables as T
from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
from gr_ieee80211_tpu_torch.utils import trace

torch.set_num_threads(2)

#: the largest LLR gap, over the row's largest |LLR| and its channel's
#: condition number, from the twin as it runs on the CPU
LLR_REL = 1e-5

#: (fmt, mcs, nss) of the stage's branches: every constellation, HT's
#: two-stream pilots, VHT's two streams
CONFIGS = [(Fmt.L, 0, 1), (Fmt.L, 4, 1), (Fmt.L, 7, 1), (Fmt.HT, 1, 1),
           (Fmt.HT, 5, 1), (Fmt.HT, 12, 2), (Fmt.HT, 15, 2), (Fmt.VHT, 8, 1),
           (Fmt.VHT, 0, 2), (Fmt.VHT, 8, 2)]


def _cid(c) -> str:
    return f"{c[0].name}{c[1]}x{c[2]}"


def _case(conf, nrx: int, B: int, nsym: int | None, seed: int):
    return W.demod_case(conf, nrx, B, nsym, seed)


def _old_stage(xs, ds, h, pilot_h, cfg):
    """The stage as ``models/rx._payload_core`` wrote it before K8."""
    grids = OF.fft_syms(cstack([OF.extract_sym_windows(xs[:, r], ds,
                                                       cfg.nsym)
                                for r in range(xs.shape[1])], dim=1))
    llr = OF.equalize_and_demap(grids, h, pilot_h, cfg)
    return OF.deinterleave_deparse(llr, cfg)


def _kernel_counts(before: dict) -> dict:
    after = trace.snapshot()
    return {k: v for k, v in after.items()
            if k.startswith("kernel.") and v != before.get(k, 0)}


@pytest.mark.parametrize("conf", CONFIGS, ids=_cid)
@pytest.mark.parametrize("nrx", [1, 2])
def test_payload_demod_runs_the_twin_on_cpu(conf, nrx):
    """CPU tensors take the twin, which is the stage as it was, and count
    no launch."""
    before = trace.snapshot()
    cfg, xs, ds, h, pilot_h = _case(conf, nrx, 3, None, 11 + nrx)
    got = OF.payload_demod(xs, ds, h, pilot_h, cfg)
    assert got.shape == (3, cfg.nsym * cfg.ncbps)
    assert got.dtype == torch.float32
    assert torch.equal(got, OF.payload_demod_ref(xs, ds, h, pilot_h, cfg))
    assert torch.equal(got, _old_stage(xs, ds, h, pilot_h, cfg))
    assert not _kernel_counts(before)


def test_payload_grids_are_the_symbol_dfts():
    """The dd pass's grids: each antenna's data-symbol windows through the
    DFT, as the stage took them."""
    cfg, xs, ds, _, _ = _case((Fmt.VHT, 3, 1), 2, 2, None, 5)
    g = OF.payload_grids(xs, ds, cfg.nsym)
    assert g.re.shape == (2, 2, cfg.nsym, 64)
    for r in range(2):
        w = OF.extract_sym_windows(xs[:, r], ds, cfg.nsym)
        ref = OF.fft_syms(w)
        assert torch.equal(g.re[:, r], ref.re)
        assert torch.equal(g.im[:, r], ref.im)


def _bad_inputs():
    cfg1 = PhyConfig(Fmt.HT, 3, 1, 100)
    cfg2 = PhyConfig(Fmt.HT, 11, 2, 100)
    ds, n = _data_start(cfg1), _data_start(cfg1) + 80 * cfg1.nsym + 16
    x = torch.zeros((2, 1, n))
    x2 = torch.zeros((2, 2, n))
    h = torch.zeros((2, 1, 1, 64))
    p = torch.zeros((2, 1, 4))

    def c(t):
        return CF(t, t)
    return [
        ((c(x[:, 0]), ds, c(h), c(p), cfg1), "2-D windows"),
        ((CF(x, x[:, :, :-1]), ds, c(h), c(p), cfg1), "re and im differ"),
        ((c(x.double()), ds, c(h), c(p), cfg1), "float64 windows"),
        ((c(x), ds, c(h.double()), c(p), cfg1), "float64 estimate"),
        ((c(x.to("meta")), ds, c(h.to("meta")), c(p.to("meta")), cfg1),
         "meta device"),
        ((c(torch.zeros((2, 3, n))), ds, c(torch.zeros((2, 3, 1, 64))),
          c(torch.zeros((2, 3, 4))), cfg1), "three antennas"),
        ((c(x), ds, c(h[:1]), c(p), cfg1), "estimate of other rows"),
        ((c(x2), ds, c(torch.zeros((2, 2, 1, 64))), c(torch.zeros((2, 2, 4))),
          cfg2), "one stream's estimate for two"),
        ((c(x), ds, c(h), c(p[:, :, :3]), cfg1), "three pilots"),
        ((c(x[:, :, :n - 100]), ds, c(h), c(p), cfg1), "windows too short"),
        ((c(x), -1, c(h), c(p), cfg1), "negative data start")]


@pytest.mark.parametrize("bad", _bad_inputs(), ids=lambda b: b[1])
def test_payload_demod_checks_inputs(bad):
    """The wrapper refuses what K8 cannot take, on any device; no launch
    is counted."""
    before = trace.snapshot()
    with pytest.raises(ValueError):
        OF.payload_demod(*bad[0])
    assert not _kernel_counts(before)


def _cu() -> str:
    return (PCL.CSRC / "payload_demod.cu").read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)[;,]", src).group(1))


def test_payload_demod_source_matches_wrapper():
    """The C entry point and its argument list, the constant table's head,
    its pilot period and the format codes agree between
    ``csrc/payload_demod.cu`` and the wrapper; the table holds the twin's
    DFT matrices, data and pilot tones."""
    src = _cu()
    sig = re.search(r"int gr80211_payload_demod\(([^)]*)\)", src).group(1)
    args = [a.split()[-1].lstrip("*") for a in sig.split(",")]
    assert args == ["xr", "xi", "h_re", "h_im", "p_re", "p_im", "tab", "out",
                    "n", "batch", "nrx", "nss", "fmt", "nbpscs", "nsym",
                    "data_start", "pil_at", "perm_at", "kmod", "stream"]
    assert PCL._ENTRY_POINTS["gr80211_payload_demod"] == (
        [PCL._VP] * 8 + [PCL._CI] * 10 + [PCL._CF, PCL._VP])
    assert PCL.CSRC / "payload_demod.cu" in PCL.sources()
    off = 0
    for name, size in OF.DEMOD_HEAD:
        assert _const(src, name) == off, name
        off += size
    assert _const(src, "kHeadSize") == off
    assert _const(src, "kPilotPeriod") == OF.PILOT_PERIOD
    assert [_const(src, k) for k in ("kFmtL", "kFmtHt", "kFmtVht")] == [
        int(Fmt.L), int(Fmt.HT), int(Fmt.VHT)]
    tab, at = OF._demod_parts()
    assert tab.dtype == np.float32 and min(at.values()) == off
    from gr_ieee80211_tpu_torch.ops.cplx import _dft64_mats
    c, s = _dft64_mats()
    assert np.array_equal(tab[:4096].reshape(64, 64), c)
    assert np.array_equal(tab[4096:8192].reshape(64, 64), s)
    for idx, start in ((T.DATA_IDX_L, 8192), (T.DATA_IDX_NL, 8256)):
        pos = tab[start: start + 64]
        assert np.array_equal(np.flatnonzero(pos >= 0), np.sort(idx))
        assert np.array_equal(pos[idx], np.arange(idx.size))
    assert np.array_equal(tab[8320: 8324], T.PILOT_IDX)
    assert np.array_equal(OF._demod_table(torch.device("cpu")).numpy(), tab)


@pytest.mark.parametrize("conf", CONFIGS, ids=_cid)
def test_payload_demod_table_repeats_pilots_and_permutation(conf):
    """The table's pilot part is ``data_pilots`` over every symbol count
    (one period, read at m mod 508), and its per-symbol coded positions
    give the whole bucket's ``_deint_deparse_perm``."""
    fmt, mcs, nss = conf
    tab, at = OF._demod_parts()
    cfg = PhyConfig(fmt, mcs, nss, 100, ampdu=fmt == Fmt.VHT)
    rows = 2 if fmt == Fmt.HT and nss == 2 else 1
    pil = tab[at["pilots", fmt, nss]:][: OF.PILOT_PERIOD * rows * 4].reshape(
        OF.PILOT_PERIOD, rows, 4)
    full = data_pilots(fmt, nss, 1100)[:, :rows]
    assert np.array_equal(pil[np.arange(1100) % OF.PILOT_PERIOD], full)
    pos = tab[at["perm", fmt == Fmt.L, cfg.nbpscs, nss]:][: cfg.ncbps]
    assert np.array_equal(np.sort(pos), np.arange(cfg.ncbps))
    for nsym in (1, 3, 17):
        perm = OF._deint_deparse_perm(fmt, cfg.nbpscs, nss, nsym)
        ncbpss = cfg.ncbpss
        # the LLR at (stream, symbol, q) goes to symbol * ncbps + pos[...]
        src = np.arange(nss * nsym * ncbpss)
        st, m, q = src // (nsym * ncbpss), src // ncbpss % nsym, src % ncbpss
        dest = m * cfg.ncbps + pos[st * ncbpss + q].astype(np.int64)
        assert np.array_equal(perm[dest], src)


@pytest.fixture(scope="module")
def k8_on_cpu(tmp_path_factory):
    """K8's source built for the CPU (g++, the shim header)."""
    return _cuda_cpu.build("payload_demod", "gr80211_payload_demod",
                           tmp_path_factory.mktemp("k8_cpu"))


def _sqrt_rn(x: torch.Tensor, _sqrt=torch.sqrt) -> torch.Tensor:
    """A correctly rounded float32 square root, as the card takes it (the
    float64 root of a float32 rounds to the float32 one)."""
    if x.dtype != torch.float32:
        return _sqrt(x)
    return _sqrt(x.double()).float()


def _csum_as_the_card(cf: CF, dim, _csum=OF.csum) -> CF:
    """``csum``, with the pilot sum over (antennas, pilots) in the order of
    PyTorch's CUDA reduction: each pilot's antennas, then (p0 + p2) +
    (p1 + p3)."""
    if dim != (1, 3):
        return _csum(cf, dim)

    def one(v):
        s = v[:, 0]
        for r in range(1, v.shape[1]):
            s = s + v[:, r]
        return (s[..., 0] + s[..., 2]) + (s[..., 1] + s[..., 3])
    return CF(one(cf.re), one(cf.im))


def _twin_as_the_card(monkeypatch, *args) -> torch.Tensor:
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", _sqrt_rn)
        m.setattr(OF, "csum", _csum_as_the_card)
        return OF.payload_demod_ref(*args)


def _run_on_cpu(fn, monkeypatch, xs, ds, h, pilot_h, cfg):
    """K8 through the wrapper on the CPU build: (LLRs, each launch's
    shape)."""
    shapes = []

    def launch(name, dev, *args, shape):
        assert name == "gr80211_payload_demod"
        assert fn(*args, None) == 0
        shapes.append(shape)
    monkeypatch.setattr(OF, "launch", launch)
    return OF._demod_kernel(xs, ds, h, pilot_h, cfg), shapes


#: (conf, nrx, B, nsym: None = the packets' own) of the CPU build's cases:
#: every branch at its own length, one symbol, and two or three tiles
KERNEL_CASES = ([(c, nrx, 4, None) for c in CONFIGS for nrx in (1, 2)
                 if nrx >= c[2]]
                + [((Fmt.VHT, 8, 2), 2, 3, 1), ((Fmt.HT, 5, 1), 2, 3, 1),
                   ((Fmt.L, 4, 1), 1, 3, 1), ((Fmt.HT, 12, 2), 1, 2, 4),
                   ((Fmt.VHT, 4, 1), 1, 64, 2), ((Fmt.VHT, 2, 2), 2, 8, 26),
                   ((Fmt.HT, 1, 1), 2, 6, 40), ((Fmt.L, 6, 1), 1, 5, 17)])


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: f"{_cid(c[0])}-rx{c[1]}-B{c[2]}-"
                                       f"n{c[3] or 'own'}")
def test_k8_source_matches_the_twin_on_cpu(k8_on_cpu, monkeypatch, case):
    """The kernel's arithmetic against the twin's: one launch a bucket, at
    its shape; every LLR bit-equal to the twin's computed as the card
    computes it, and within ``LLR_REL`` times the row's condition number
    of its largest |LLR| of the twin's as it runs on the CPU."""
    conf, nrx, B, nsym = case
    cfg, xs, ds, h, pilot_h = _case(conf, nrx, B, nsym, 200 + B + nrx)
    got, shapes = _run_on_cpu(k8_on_cpu, monkeypatch, xs, ds, h, pilot_h,
                              cfg)
    assert shapes == [(B, nrx, cfg.nss, cfg.nsym)]
    assert torch.equal(got, _twin_as_the_card(monkeypatch, xs, ds, h,
                                              pilot_h, cfg))
    ref = OF.payload_demod_ref(xs, ds, h, pilot_h, cfg)
    gap = (got - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)
    kappa = W.row_condition(h, cfg.fmt == Fmt.L)
    assert bool((gap.double() <= LLR_REL * kappa).all()), float(gap.max())
