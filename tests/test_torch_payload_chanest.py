"""The payload channel estimate's wrapper (``ops/ofdm.payload_chanest``,
K7 on the card) on the CPU: CPU tensors take the plain twin and launch
nothing; the wrapper refuses what the kernel cannot take; the C source
agrees with the wrapper on its entry point and its constant table; and
the kernel's source, compiled for the CPU with a header that runs one OS
thread per CUDA thread (``tests/cuda_cpu_shim.h``), returns the twin's
estimates: bit-equal where nothing is summed over the tones, within
float32 rounding of the twin's sums in the one-stream refinement.

K7 itself is held to the twin on the card by
``tests/test_torch_payload_chanest_card.py``."""
import re

import numpy as np
import pytest
import torch

import _chanest_windows as W
import _cuda_cpu
from gr_ieee80211_tpu_torch.ops import cuda_lib as PCL
from gr_ieee80211_tpu_torch.ops import ofdm as OF
from gr_ieee80211_tpu_torch.ops.cplx import CF, csum, cstack, from_numpy_cf
from gr_ieee80211_tpu_torch.spec import tables as T
from gr_ieee80211_tpu_torch.spec.params import Fmt
from gr_ieee80211_tpu_torch.utils import trace

torch.set_num_threads(2)

#: (fmt, mcs, nss, with SIG-B) of the stage's branches
CASES = [(Fmt.L, 5, 1, False), (Fmt.HT, 3, 1, False), (Fmt.VHT, 4, 1, True),
         (Fmt.VHT, 4, 1, False), (Fmt.HT, 11, 2, False),
         (Fmt.VHT, 5, 2, True)]


def _inputs(case, nrx, B, snr, seed):
    fmt, mcs, nss, sigb = case
    cfg, x, sigb_gi = W.windows(fmt, mcs, nss, nrx, B, snr, seed)
    return cfg, from_numpy_cf(x, "cpu"), sigb_gi if sigb else None


def _old_stage(xs, cfg, sigb_gi):
    """The stage as ``models/rx._payload_core`` wrote it before K7."""
    pidx = torch.from_numpy(T.PILOT_IDX.astype(np.int64))
    if cfg.fmt == Fmt.L:
        h0 = cstack([OF.legacy_chanest(xs[:, r], 0)
                     for r in range(xs.shape[1])], dim=1)
        return h0[:, :, None, :], h0[:, :, pidx]
    h, pilot_h = OF.nl_chanest(xs, 208 + 160 + 80, cfg.nltf, cfg.nss)
    if cfg.nss == 1:
        h, pilot_h = OF.refine_chanest_siso(xs, h, pilot_h, fmt=cfg.fmt,
                                            sigb_gi=sigb_gi)
    if cfg.fmt == Fmt.HT:
        pilot_h = csum(h[:, :, :, pidx], dim=2)
    return h, pilot_h


def _equal(a: CF, b: CF) -> bool:
    return torch.equal(a.re, b.re) and torch.equal(a.im, b.im)


def _kernel_counts(before: dict) -> dict:
    """The ``kernel.*`` counters that moved since ``before``."""
    after = trace.snapshot()
    return {k: v for k, v in after.items()
            if k.startswith("kernel.") and v != before.get(k, 0)}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0].name}{c[2]}"
                         f"{'sigb' if c[3] else ''}")
@pytest.mark.parametrize("nrx", [1, 2])
def test_payload_chanest_runs_the_twin_on_cpu(case, nrx):
    """CPU tensors take the twin, which is the stage as it was, and count
    no launch."""
    before = trace.snapshot()
    cfg, xs, sigb_gi = _inputs(case, nrx, 3, 20.0, 7 + nrx)
    h, pilot_h = OF.payload_chanest(xs, cfg.fmt, cfg.nltf, cfg.nss, sigb_gi)
    assert h.re.shape == (3, nrx, cfg.nss, 64)
    assert pilot_h.re.shape == (3, nrx, 4)
    ref = OF.payload_chanest_ref(xs, cfg.fmt, cfg.nltf, cfg.nss, sigb_gi)
    old = _old_stage(xs, cfg, sigb_gi)
    for a, b in zip((h, pilot_h), ref):
        assert _equal(a, b)
    for a, b in zip((h, pilot_h), old):
        assert _equal(a, b)
    assert not _kernel_counts(before)


def _bad_inputs():
    x = torch.zeros((2, 1, 900))
    return [
        ((CF(x[0], x[0]), Fmt.L, 0, 1), "2-D windows"),
        ((CF(x, x[:, :, :800]), Fmt.L, 0, 1), "re and im differ"),
        ((CF(x.double(), x.double()), Fmt.L, 0, 1), "float64"),
        ((CF(x.bfloat16(), x.bfloat16()), Fmt.L, 0, 1), "bfloat16"),
        ((CF(x.to("meta"), x.to("meta")), Fmt.L, 0, 1), "meta device"),
        ((CF(x, x), Fmt.L, 0, 2), "two streams of a legacy packet"),
        ((CF(x, x), Fmt.HT, 1, 2), "two streams from one LTF"),
        ((CF(x, x), Fmt.VHT, 4, 3), "three streams"),
        ((CF(x, x), Fmt.HT, 0, 1), "no LTF")]


@pytest.mark.parametrize("bad", _bad_inputs(), ids=lambda b: b[1])
def test_payload_chanest_checks_inputs(bad):
    """The wrapper refuses what K7 cannot take, on any device; no launch
    is counted."""
    before = trace.snapshot()
    with pytest.raises(ValueError):
        OF.payload_chanest(*bad[0])
    assert not _kernel_counts(before)


def _cu() -> str:
    return (PCL.CSRC / "payload_chanest.cu").read_text()


def test_payload_chanest_source_matches_wrapper():
    """The C entry point and its argument list, the constant table's
    layout and contents, and the HT/VHT-LTF start agree between
    ``csrc/payload_chanest.cu`` and the wrapper."""
    src = _cu()
    sig = re.search(r"int gr80211_payload_chanest\(([^)]*)\)", src).group(1)
    args = [a.split()[-1].lstrip("*") for a in sig.split(",")]
    assert args == ["xr", "xi", "tab", "h_re", "h_im", "p_re", "p_im", "n",
                    "batch", "nrx", "fmt", "nltf", "nss", "refine",
                    "sigb_start", "gain", "coh_min", "stream"]
    assert PCL._ENTRY_POINTS["gr80211_payload_chanest"] == (
        [PCL._VP] * 7 + [PCL._CI] * 8 + [PCL._CF] * 2 + [PCL._VP])
    assert PCL.CSRC / "payload_chanest.cu" in PCL.sources()
    off = 0
    for name, size in OF.CHANEST_TABLE:
        assert int(re.search(rf"{name} = (\d+);", src).group(1)) == off, name
        off += size
    assert int(re.search(r"kTableSize = (\d+);", src).group(1)) == off
    assert int(re.search(r"kNlLtf = (\d+);", src).group(1)) == OF.NL_LTF_START
    tab = OF._chanest_table(torch.device("cpu")).numpy()
    assert tab.dtype == np.float32 and tab.shape == (off,)
    at = dict(zip([n for n, _ in OF.CHANEST_TABLE],
                  np.cumsum([0] + [s for _, s in OF.CHANEST_TABLE])))
    from gr_ieee80211_tpu_torch.ops.cplx import _dft64_mats
    assert np.array_equal(tab[:4096].reshape(64, 64), _dft64_mats()[0])
    act, p_re, _ = OF._delay_projector(False)
    assert np.array_equal(tab[at["kProjRe"]: at["kProjIm"]].reshape(56, 56),
                          p_re)
    pos = tab[at["kActPos"]: at["kPilot"]]
    assert np.array_equal(np.flatnonzero(pos >= 0), act)
    assert np.array_equal(pos[act], np.arange(56))
    assert np.array_equal(tab[at["kPilot"]: at["kPLtf"]], T.PILOT_IDX)


@pytest.fixture(scope="module")
def k7_on_cpu(tmp_path_factory):
    """K7's source built for the CPU (g++, the shim header): its C entry
    point, with the wrapper's argument types."""
    return _cuda_cpu.build("payload_chanest", "gr80211_payload_chanest",
                           tmp_path_factory.mktemp("k7_cpu"))


def _run_on_cpu(fn, monkeypatch, xs, cfg, sigb_gi, refine):
    """K7 through the wrapper on the CPU build: (outputs, the shape of each
    launch)."""
    shapes = []

    def launch(name, dev, *args, shape):
        assert name == "gr80211_payload_chanest"
        assert fn(*args, None) == 0
        shapes.append(shape)
    monkeypatch.setattr(OF, "launch", launch)
    return OF._chanest_kernel(xs, cfg.fmt, cfg.nltf, cfg.nss, sigb_gi,
                              refine), shapes


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0].name}{c[2]}"
                         f"{'sigb' if c[3] else ''}")
@pytest.mark.parametrize("nrx,snr", [(1, 30.0), (2, 10.0)])
def test_k7_source_matches_the_twin_on_cpu(k7_on_cpu, monkeypatch, case, nrx,
                                           snr):
    """The kernel's arithmetic against the twin's: the L and P-matrix
    estimates bit-equal (and a one-stream bucket's estimate before its
    refinement); the refined ones within 1e-5 of the row's largest |h|."""
    cfg, xs, sigb_gi = _inputs(case, nrx, 2, snr, 100 + nrx)
    refine = cfg.fmt != Fmt.L and cfg.nss == 1
    got, shapes = _run_on_cpu(k7_on_cpu, monkeypatch, xs, cfg, sigb_gi,
                              refine)
    # one launch a bucket, at the bucket's shape
    assert shapes == [(2, nrx, int(cfg.fmt), cfg.nss)]
    ref = OF.payload_chanest_ref(xs, cfg.fmt, cfg.nltf, cfg.nss, sigb_gi)
    if not refine:
        assert _equal(got[0], ref[0]) and _equal(got[1], ref[1])
        return
    hmax = torch.sqrt(ref[0].re ** 2 + ref[0].im ** 2).amax(dim=(1, 2, 3))
    for a, b in zip(got, ref):
        gap = torch.maximum((a.re - b.re).abs(), (a.im - b.im).abs())
        assert (gap.reshape(2, -1).amax(dim=1) <= 1e-5 * hmax).all()
    h0, p0 = OF.nl_chanest(xs, OF.NL_LTF_START, cfg.nltf, 1)
    if cfg.fmt == Fmt.HT:
        p0 = csum(CF(h0.re[..., T.PILOT_IDX], h0.im[..., T.PILOT_IDX]), dim=2)
    (h1, p1), _ = _run_on_cpu(k7_on_cpu, monkeypatch, xs, cfg, sigb_gi,
                              False)
    assert _equal(h1, h0) and _equal(p1, p0)
