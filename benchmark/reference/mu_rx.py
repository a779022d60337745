"""The plain reference of the MU-MIMO station's receiver: the decode of
a VHT MU PPDU's own stream from a known sync, in plain PyTorch, float64 /
complex128.

Given the (nrx, n) samples of a PPDU from its L-LTF index on, its CFO,
the space-time streams of the PPDU (VHT-SIG-A's NSTS fields: their sum
``n_total`` and ``own``, the first stream of this station's user) and its
symbol count (from L-SIG), :func:`decode` runs, in order, the clauses of
IEEE Std 802.11-2020 cl. 21 for a VHT MU station:

1. derotation by the CFO;
2. the channel estimate of all ``n_total`` space-time streams from the
   VHT-LTFs through the P matrix (21.3.8.3.5; the VHT-LTF pilot tones
   carry the R row, so there the estimate is that of the streams' sum),
   then the own stream's column;
3. VHT-SIG-B (21.3.8.3.6): the symbol's FFT, its common phase from its
   pilots, the own column's equalize, the BPSK demap, the deinterleave,
   a plain K = 7 Viterbi of its 26 bits, then the MU fields: LENGTH (16
   bits, in units of 4 bytes), MCS (4 bits), a zero tail;
4. the data symbols (21.3.10): each one's FFT and common phase from its
   pilots, the own column's equalize, the max-log demap, the deinterleave,
   depuncture, the Viterbi and the descramble;
5. the SERVICE field's CRC-8 against SIG-B's (21.3.8.3.6: bits 8-15 of
   SERVICE carry the CRC of SIG-B's 20 body bits), then the PSDU.

It is built from ``mimo_rx.py``'s pieces (the staged window, the FFT, the
P-matrix estimate, the common phase, the one-stream equalize, the demap,
deinterleave, depuncture, Viterbi, descramble), and takes that file's
departures, each a convention of the program under test:

* input: the samples are read as the program's payload path reads them,
  each float32 part rounded to bfloat16 before the float64 arithmetic.
  The program reads its SIG-B symbol from float32 windows; here SIG-B is
  read from the same staged samples as the data (at 30 dB the BPSK
  symbol's decision does not move by a bfloat16 rounding);
* timing: the FFT windows lie at nominal offsets from the program's own
  L-LTF index, a few samples inside the guard interval (the shift is the
  same in every window, so it cancels in the equalized symbols);
* LLRs: the piecewise-linear max-log form in units of the constellation's
  lattice, with no noise or channel-state weighting; positive means 1;
* SIG-B's pilots carry the VHT pilot pattern with no polarity, as the
  reference transmitter (``tx_mu.py``) sends them.

It imports torch, numpy and its frozen siblings only: nothing of the
program, nothing of JAX.  Nothing here is float32, so TF32 never
applies; :func:`decode` turns it off for its own duration all the same.
"""
from __future__ import annotations

import numpy as np
import torch

from . import mimo_rx as MRX
from . import tables as T
from .params import Fmt, PhyConfig

C128 = MRX.C128
F64 = MRX.F64


def starts(n_total: int) -> tuple[int, int]:
    """(VHT-SIG-B start, data start) of an MU PPDU with ``n_total``
    space-time streams, from the L-LTF index."""
    sigb = MRX.NL_LTF + 80 * int(T.N_LTF_OF_NSTS[n_total])
    return sigb, sigb + 80


def n_need(n_total: int, nsym: int) -> int:
    return starts(n_total)[1] + 80 * nsym + 16


def chanest(xs: torch.Tensor, n_total: int):
    """(H (B, nrx, n_total, 64), pilot channel (B, nrx, 4)): every
    space-time stream's VHT-LTF estimate, as ``mimo_rx.chanest`` makes it
    for a VHT PPDU of ``n_total`` streams."""
    return MRX.chanest(xs, PhyConfig(Fmt.VHT, 0, n_total, 1, ampdu=True))


def _common_phase(g: torch.Tensor, expect: torch.Tensor) -> torch.Tensor:
    """g (B, nrx, ..., 64) turned by the angle of its pilots against
    ``expect`` (B, nrx, ..., 4), summed over antennas and pilots."""
    pk = torch.as_tensor(T.PILOT_IDX, dtype=torch.int64)
    dims = (1, g.dim() - 1)
    c = (g[..., pk] * expect.conj()).sum(dim=dims)
    return g * torch.exp(-1j * torch.angle(c)).reshape(
        c.shape[0], 1, *c.shape[1:], 1)


#: SIG-B's own transmit vector: one symbol of BPSK rate 1/2 on 52 tones
SIGB_CFG = PhyConfig(Fmt.VHT, 0, 1, 1, ampdu=True, mu_nsym=1)


def sigb(xs: torch.Tensor, h_own: torch.Tensor, pilot_h: torch.Tensor,
         n_total: int) -> dict:
    """Step 3: ``bits`` (B, 26) uint8 and the parsed ``length`` (bytes),
    ``mcs``, ``tail_ok`` and ``crc`` (B, 8) of each row's SIG-B; ``llr``
    (B, 52) its coded-order LLRs."""
    g = MRX._sym(xs, starts(n_total)[0])                  # (B, nrx, 64)
    pv = torch.as_tensor(T.PILOT_VHT, dtype=C128)
    g = _common_phase(g, pilot_h * pv)
    di = MRX.data_idx(SIGB_CFG)
    eq = MRX.equalize(g[:, :, None, di], h_own[:, :, None, di])
    llr = MRX.coded_llrs(MRX.demap(eq, 1), SIGB_CFG)
    bits = MRX.viterbi(MRX.depuncture(llr, "1/2", 26))
    b = bits.numpy().astype(np.int64)
    return {"bits": bits, "llr": llr,
            "length": 4 * (b[:, :16] @ (1 << np.arange(16))),
            "mcs": b[:, 16:20] @ (1 << np.arange(4)),
            "tail_ok": ~b[:, 20:26].any(axis=1),
            "crc": np.stack([T.crc8_bits(r[:20]) for r in b])}


def data(xs: torch.Tensor, h_own: torch.Tensor, pilot_h: torch.Tensor,
         n_total: int, cfg: PhyConfig) -> dict:
    """Step 4 for rows of one user config ``cfg`` (VHT, the user's MCS and
    streams, ``mu_nsym`` the PPDU's symbol count): ``eq`` (B, nss, nsym,
    52), ``llr`` (B, nsym * ncbps) the coded-order LLRs, ``bits`` (B,
    nsym * ndbps) the descrambled data bits."""
    d0 = starts(n_total)[1]
    w = torch.stack([xs[..., d0 + 80 * n + 16: d0 + 80 * n + 80]
                     for n in range(cfg.nsym)], dim=2)
    grids = MRX.phase_corrected(MRX.fft64(w), h_own, pilot_h, cfg)
    di = MRX.data_idx(cfg)
    eq = MRX.equalize(grids[..., di], h_own[..., di])
    llr = MRX.coded_llrs(MRX.demap(eq, cfg.nbpscs), cfg)
    bits = MRX.descramble(MRX.viterbi(
        MRX.depuncture(llr, cfg.cr, cfg.n_trellis)))
    return {"eq": eq, "llr": llr, "bits": bits}


def decode(xs: torch.Tensor, n_total: int, own: int, nss: int,
           nsym: int) -> list[dict]:
    """Decode the own stream(s) of a batch of MU PPDUs of one stream
    layout and symbol count.

    xs: (B, nrx, >= n_need) derotated samples from the L-LTF index.
    Returns, a row each: ``h`` (nrx, n_total, 64), ``sigb`` (26,) bits,
    ``sigb_llr`` (52,), ``cfg`` (the user's config, or None where SIG-B
    gives none), and where it does ``llr`` (the data's coded-order LLRs),
    ``service`` (16,) and ``psdu`` bytes, and ``service_ok`` (SERVICE's
    CRC equals SIG-B's)."""
    with MRX._no_tf32():
        xs = xs.to(C128)
        h, pilot_h = chanest(xs, n_total)
        h_own = h[:, :, own: own + nss]
        sb = sigb(xs, h_own[:, :, 0], pilot_h, n_total)
        out = []
        for b in range(xs.shape[0]):
            row = {"h": h[b], "sigb": sb["bits"][b], "sigb_llr": sb["llr"][b],
                   "cfg": None}
            mcs, length = int(sb["mcs"][b]), int(sb["length"][b])
            if sb["tail_ok"][b] and mcs <= 8 and 1 <= length <= 4095:
                row["cfg"] = PhyConfig(Fmt.VHT, mcs, nss, length,
                                       ampdu=True, mu_nsym=nsym)
            out.append(row)
        by_cfg: dict = {}
        for b, row in enumerate(out):
            if row["cfg"] is not None:
                by_cfg.setdefault(row["cfg"], []).append(b)
        for cfg, rows in by_cfg.items():
            sel = torch.as_tensor(rows)
            d = data(xs[sel], h_own[sel], pilot_h[sel], n_total, cfg)
            for j, b in enumerate(rows):
                bits = d["bits"][j].numpy()
                out[b].update(
                    llr=d["llr"][j], eq=d["eq"][j], service=bits[:16],
                    service_ok=bool(np.array_equal(bits[8:16],
                                                   sb["crc"][b])),
                    psdu=MRX.to_bytes(d["bits"][j:j + 1, 16:
                                                16 + 8 * cfg.psdu_len])[0])
    return out


def decode_at(views, starts_, cfos, n_total: int, own: int, nss: int,
              nsym: int) -> list[dict]:
    """:func:`decode` of PPDUs each given by its view (nrx, N), its L-LTF
    index and its CFO in Hz (the program's own, say)."""
    n = n_need(n_total, nsym)
    xs = torch.stack([MRX.window(v, int(s), float(c), n)
                      for v, s, c in zip(views, starts_, cfos)])
    return decode(xs, n_total, own, nss, nsym)
