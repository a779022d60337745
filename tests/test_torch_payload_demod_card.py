"""K8 (``csrc/payload_demod.cu``, the payload demodulation of a bucket in
one launch) against its plain twin ``ops/ofdm.payload_demod_ref`` on the
card: at the daemon's bucket sizes (1-4 rows) over L / HT / VHT, BPSK to
256-QAM, one and two antennas and streams; at the chain's (4096, 1) VHT
MCS7 bucket and at (4096, 2) with two streams; and through its three
callers, ``models/rx._payload_core``, ``_payload_core_mu`` and
``parallel/mesh.payload_decode_dp``, which reach the stage only through
K8 on the card and return the CPU's bits.

Tolerances.  K8 takes the twin's arithmetic in its order, and its pilot
sum (4 or 8 terms a symbol, whose order the twin leaves to PyTorch's
reduction) in the order PyTorch's CUDA reduction took on the H100 (each
pilot's antennas, then (p0 + p2) + (p1 + p3)).  Where the twin's sum
equals the sum in that order, which ``_order_matched`` checks, the
symbol's LLRs are bit-equal, but for a symbol in ``DFT_FLIP_SHARE`` whose
float64 DFT cuBLAS sums in another order and rounds across a float32
boundary.  Should PyTorch take another order, a symbol's phasor may
differ from the twin's by a float32 rounding: that moves the
phase-corrected symbols by ~1e-7 of their size, which one stream carries
to the LLRs as it is and the two-stream ZF magnifies by up to the
channel's condition number, so every LLR lies within ``LLR_REL`` times
the row's largest condition number (1 for one stream, ``row_condition``)
of the row's largest |LLR| of the twin's.  Each case prints its
bit-equal and order-matched shares and its largest gap.

Every test needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs where the card is:

    python -m pytest --noconftest -q -s tests/test_torch_payload_demod_card.py
"""
import numpy as np
import pytest
import torch

import _chanest_windows as W
from gr_ieee80211_tpu_torch.models import rx as RX
from gr_ieee80211_tpu_torch.ops import ofdm as OF
from gr_ieee80211_tpu_torch.ops.cplx import CF, csum, from_numpy_cf
from gr_ieee80211_tpu_torch.parallel import mesh as M
from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
from gr_ieee80211_tpu_torch.utils import trace

pytestmark = pytest.mark.gpu

#: the largest LLR gap over the row's largest |LLR| and its channel's
#: condition number
LLR_REL = 1e-5
#: the share of order-matched symbols allowed to differ by a DFT rounding
DFT_FLIP_SHARE = 1e-4

#: (fmt, mcs, nss) of the stage's branches
CONFIGS = [(Fmt.L, 0, 1), (Fmt.L, 7, 1), (Fmt.HT, 2, 1), (Fmt.HT, 5, 1),
           (Fmt.HT, 9, 2), (Fmt.HT, 15, 2), (Fmt.VHT, 4, 1), (Fmt.VHT, 8, 1),
           (Fmt.VHT, 0, 2), (Fmt.VHT, 8, 2)]
#: the stage's functions that the card's path must not call
TWIN_PARTS = ("payload_demod_ref", "equalize_and_demap", "zf_equalize",
              "llr_demap", "deinterleave_deparse")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _launches() -> float:
    return trace.snapshot().get("kernel.payload_demod.launches", 0)


def _cid(c) -> str:
    return f"{c[0].name}{c[1]}x{c[2]}"


def _order_matched(xs, ds, h, pilot_h, cfg) -> torch.Tensor:
    """(B, nsym) bool: the twin's pilot sum (``equalize_and_demap``'s, by
    PyTorch's reduction) equals the sum in K8's order."""
    dev = xs.re.device
    grids = OF.payload_grids(xs, ds, cfg.nsym)
    pidx = OF._idx("PILOT_IDX", dev)
    pil = torch.from_numpy(OF._pilot_matrix(cfg.fmt, cfg.nss, cfg.nsym)).to(dev)
    if cfg.fmt == Fmt.HT and cfg.nss == 2:
        hp = h[:, :, :, pidx]
        pt = pil.permute(1, 0, 2)[None, None]
        exp_p = CF((hp.re[:, :, :, None, :] * pt).sum(dim=2),
                   (hp.im[:, :, :, None, :] * pt).sum(dim=2))
    else:
        p0 = pil[:, 0]
        exp_p = CF(pilot_h.re[:, :, None, :] * p0[None, None],
                   pilot_h.im[:, :, None, :] * p0[None, None])
    t = grids[:, :, :, pidx].mul_conj(exp_p)
    ref = csum(t, dim=(1, 3))
    s = t[:, 0]
    for r in range(1, t.re.shape[1]):
        s = s + t[:, r]
    mine = (s[..., 0] + s[..., 2]) + (s[..., 1] + s[..., 3])
    return (ref.re == mine.re) & (ref.im == mine.im)


def _check(got, ref, matched, h, cfg, tag: str):
    """Hold K8's LLRs to the twin's; print the case's shares and gap."""
    B = got.shape[0]
    assert got.shape == ref.shape == (B, cfg.nsym * cfg.ncbps), tag
    assert bool(torch.isfinite(got).all()), tag
    gap = ((got - ref).abs().amax(dim=1)
           / ref.abs().amax(dim=1).clamp(min=1e-30)).double()
    kappa = W.row_condition(h, cfg.fmt == Fmt.L)
    assert bool((gap <= LLR_REL * kappa).all()), (
        tag, float(gap.max()), float((gap / kappa).max()))
    same = (got == ref).reshape(B, cfg.nsym, cfg.ncbps).all(dim=2)
    n_matched = int(matched.sum())
    flips = int((matched & ~same).sum())
    assert flips <= DFT_FLIP_SHARE * n_matched, (tag, flips, n_matched)
    print(f"K8 {tag}: {float(same.float().mean()):.4f} of symbols bit-equal, "
          f"{n_matched} of {matched.numel()} order-matched ({flips} differ), "
          f"largest gap {float(gap.max()):.3g} of max |LLR|, "
          f"{float((gap / kappa).max()):.3g} over the condition number "
          f"(largest {float(kappa.max()):.3g})")


@pytest.mark.parametrize("conf", CONFIGS, ids=_cid)
@pytest.mark.parametrize("nrx", [1, 2])
def test_k8_matches_twin_at_the_daemons_buckets(conf, nrx):
    """One launch a call at 1-4 rows, at the packets' own length and at
    one symbol."""
    dev = _card()
    if nrx < conf[2]:
        pytest.skip("two streams need two antennas")
    for B, nsym in ((1, None), (2, None), (3, 1), (4, None)):
        cfg, xs, ds, h, ph = W.demod_case(conf, nrx, B, nsym,
                                          97 + 10 * B + nrx, dev)
        before = _launches()
        got = OF.payload_demod(xs, ds, h, ph, cfg)
        assert _launches() == before + 1
        ref = OF.payload_demod_ref(xs, ds, h, ph, cfg)
        torch.cuda.synchronize()
        _check(got, ref, _order_matched(xs, ds, h, ph, cfg), h, cfg,
               f"{_cid(conf)} nrx {nrx} B {B} nsym {cfg.nsym}")


@pytest.mark.parametrize("conf,nrx,nsym", [
    ((Fmt.VHT, 7, 1), 1, 17), ((Fmt.VHT, 7, 1), 2, 17),
    ((Fmt.VHT, 4, 2), 2, 10), ((Fmt.HT, 15, 2), 2, 40)],
    ids=["vht7-1rx", "vht7-2rx", "vht4-2ss", "ht15-2ss"])
def test_k8_matches_twin_at_the_chains_batch(conf, nrx, nsym):
    """B = 4096: the chain's VHT MCS7 bucket (17 symbols, bench.py's 530 B
    MPDU) on one and two antennas, and two streams."""
    dev = _card()
    cfg, xs, ds, h, ph = W.demod_case(conf, nrx, 4096, nsym, 4242 + nrx, dev)
    got = OF.payload_demod(xs, ds, h, ph, cfg)
    ref = OF.payload_demod_ref(xs, ds, h, ph, cfg)
    torch.cuda.synchronize()
    _check(got, ref, _order_matched(xs, ds, h, ph, cfg), h, cfg,
           f"{_cid(conf)} nrx {nrx} B 4096 nsym {nsym}")


def test_k8_empty_and_refused():
    """An empty bucket launches nothing; non-contiguous windows and a mix
    of devices raise before any launch."""
    dev = _card()
    cfg = PhyConfig(Fmt.HT, 3, 1, 100)
    n = RX._data_start(cfg) + 80 * cfg.nsym + 16
    before = _launches()
    z = torch.zeros((0, 1, n), device=dev)
    hz = torch.zeros((0, 1, 1, 64), device=dev)
    pz = torch.zeros((0, 1, 4), device=dev)
    out = OF.payload_demod(CF(z, z), 448 + 80, CF(hz, hz), CF(pz, pz), cfg)
    assert out.shape == (0, cfg.nsym * cfg.ncbps)
    x = torch.zeros((2, 1, 2 * n), device=dev)[:, :, ::2]
    h = torch.zeros((2, 1, 1, 64), device=dev)
    p = torch.zeros((2, 1, 4), device=dev)
    with pytest.raises(ValueError):
        OF.payload_demod(CF(x, x), 528, CF(h, h), CF(p, p), cfg)
    xc = x.contiguous()
    with pytest.raises(ValueError):
        OF.payload_demod(CF(xc, xc), 528, CF(h.cpu(), h.cpu()), CF(p, p), cfg)
    assert _launches() == before


@pytest.fixture
def twin_parts_count(monkeypatch):
    """Calls of the twin's parts, by name."""
    calls = {k: 0 for k in TWIN_PARTS}
    for name in TWIN_PARTS:
        orig = getattr(OF, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(OF, name, counted)
    return calls


def _stream(conf, nrx, B, seed, device):
    """(cfg, (nrx, N) stream, ltf_idx, cfo): ``windows`` laid end to end
    with 200 silent samples between them."""
    cfg, x, _ = W.windows(*conf, nrx, B, 30.0, seed)
    gap = np.zeros((B, nrx, 200), np.complex64)
    s = np.concatenate([x, gap], axis=-1)
    ltf = torch.arange(B, dtype=torch.int64) * s.shape[-1]
    stream = from_numpy_cf(np.transpose(s, (1, 0, 2)).reshape(nrx, -1),
                           device)
    return (cfg, stream, ltf.to(device),
            torch.zeros(B, dtype=torch.float32, device=device))


@pytest.mark.parametrize("conf,nrx", [((Fmt.HT, 4, 1), 1), ((Fmt.L, 6, 1), 2),
                                      ((Fmt.VHT, 5, 2), 2)],
                         ids=["ht4-siso", "l6-mrc", "vht5-zf"])
def test_payload_core_takes_k8(twin_parts_count, conf, nrx):
    """A bucket's ``_payload_core`` on the card: one K8 launch, none of
    the twin's parts, and the CPU's bits."""
    dev = _card()
    before = _launches()
    cfg, stream, ltf, cfo = _stream(conf, nrx, 3, 31 + nrx, dev)
    out = RX._payload_core(cfg, stream, ltf, cfo, nrx=nrx)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    assert twin_parts_count == {k: 0 for k in TWIN_PARTS}
    cpu = RX._payload_core(cfg, CF(stream.re.cpu(), stream.im.cpu()),
                           ltf.cpu(), cfo.cpu(), nrx=nrx)
    for k in ("psdu", "service"):
        assert torch.equal(out[k].cpu(), cpu[k]), k


def test_payload_core_mu_takes_k8(twin_parts_count):
    """The MU-STA payload (here a VHT packet of one space-time stream, the
    layout of an MU PPDU with n_total 1) on the card: one K8 launch, none
    of the twin's parts, and the CPU's bits."""
    dev = _card()
    before = _launches()
    cfg, stream, ltf, cfo = _stream((Fmt.VHT, 3, 1), 1, 4, 57, dev)
    out = RX._payload_core_mu(cfg, stream, ltf, cfo, n_total=1, own=0)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    assert twin_parts_count == {k: 0 for k in TWIN_PARTS}
    cpu = RX._payload_core_mu(cfg, CF(stream.re.cpu(), stream.im.cpu()),
                              ltf.cpu(), cfo.cpu(), n_total=1, own=0)
    for k in ("psdu", "service"):
        assert torch.equal(out[k].cpu(), cpu[k]), k


@pytest.mark.parametrize("conf,nrx", [((Fmt.HT, 3, 1), 1),
                                      ((Fmt.VHT, 2, 2), 2)],
                         ids=["ht3-1rx", "vht2-2ss"])
def test_payload_decode_dp_takes_k8(twin_parts_count, conf, nrx):
    """The mesh's packet-sharded decode on the card (two shards): one K8
    launch a shard, none of the twin's parts, and the CPU's bits."""
    dev = _card()
    cfg, x, _ = W.windows(*conf, nrx, 8, 30.0, 71 + nrx)
    step, n_samp = M.payload_decode_dp(cfg, M.make_mesh(2, device=dev),
                                       nrx=nrx)
    wins = from_numpy_cf(x[:, :, :n_samp], "cpu")
    before = _launches()
    got = [v.cpu() for v in step(wins)]
    torch.cuda.synchronize()
    assert _launches() == before + 2
    assert twin_parts_count == {k: 0 for k in TWIN_PARTS}
    cstep, _ = M.payload_decode_dp(cfg, M.make_mesh(2, device="cpu"),
                                   nrx=nrx)
    ref = cstep(wins)
    assert torch.equal(got[0], ref[0])
