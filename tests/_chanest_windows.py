"""Payload windows for the tests of the payload channel estimate and
demodulation (K7 and K8 and their twins, ``ops/ofdm.payload_chanest`` and
``payload_demod``): packets of the port's own transmitter (numpy), each
row through its own flat channel to ``nrx`` antennas, AWGN at ``snr_db``
on each antenna, cut 1-7 samples before the L-LTF (the receive path's
``ltf_idx`` origin aims early into the GI).  Imports neither JAX nor the
JAX package."""
from __future__ import annotations

import numpy as np
import torch

from gr_ieee80211_tpu_torch.gold import mac, tx
from gr_ieee80211_tpu_torch.models.rx import _data_start
from gr_ieee80211_tpu_torch.ops import ofdm as OF
from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
from gr_ieee80211_tpu_torch.spec import tables as T
from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig

ADDR = ("02:00:00:00:00:01", "02:00:00:00:00:02", "02:00:00:00:00:01")
#: the first L-LTF repeat in a transmitted waveform (L-STF, GI2)
LTF_AT = 192


def _packet(fmt: Fmt, mcs: int, nss: int, rng) -> tuple[PhyConfig, np.ndarray]:
    mpdu = mac.qos_data_frame(bytes(rng.integers(0, 256, 60, dtype=np.uint8)),
                              *ADDR, 1)
    if fmt == Fmt.VHT:
        psdu = mac.ampdu_aggregate_vht([mpdu])
        cfg = PhyConfig(fmt, mcs, nss, len(psdu), ampdu=True)
        return cfg, tx.tx_waveform(cfg, psdu, group_id=0, partial_aid=0)
    cfg = PhyConfig(fmt, mcs, nss, len(mpdu))
    return cfg, tx.tx_waveform(cfg, mpdu)


def windows(fmt: Fmt, mcs: int, nss: int, nrx: int, B: int, snr_db: float,
            seed: int, n_packets: int = 4):
    """(cfg, xs (B, nrx, n) complex64, sigb_gi): ``n_packets`` packets of
    one config (payloads from the seed), row b carrying packet b mod
    ``n_packets`` through a complex Gaussian (nrx, nss) channel of its
    own; n is what the receive path derotates for the config."""
    rng = np.random.default_rng(seed)
    pk = [_packet(fmt, mcs, nss, rng) for _ in range(n_packets)]
    cfg = pk[0][0]
    ds = _data_start(cfg)
    n = ds + 80 * cfg.nsym + 16
    waves = np.zeros((n_packets, nss, n + LTF_AT), np.complex128)
    for i, (_, w) in enumerate(pk):
        m = min(w.shape[-1], n + LTF_AT)
        waves[i, :, :m] = w[:, :m]
    early = rng.integers(1, 8, B)
    cut = np.stack([waves[b % n_packets, :, LTF_AT - early[b]:
                          LTF_AT - early[b] + n] for b in range(B)])
    h = (rng.normal(size=(B, nrx, nss))
         + 1j * rng.normal(size=(B, nrx, nss))) / np.sqrt(2 * nss)
    y = np.einsum("brs,bsn->brn", h, cut)
    amp = np.sqrt(np.mean(np.abs(y) ** 2, axis=2, keepdims=True)
                  / 10 ** (snr_db / 10) / 2)
    y = y + amp * (rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape))
    sigb_gi = ds - 80 if fmt == Fmt.VHT else None
    return cfg, y.astype(np.complex64), sigb_gi


def cfg_with_nsym(fmt: Fmt, mcs: int, nss: int, nsym: int) -> PhyConfig:
    """A config of (fmt, mcs, nss) whose data field has ``nsym`` symbols."""
    for length in range(4096):
        cfg = PhyConfig(fmt, mcs, nss, length, ampdu=fmt == Fmt.VHT)
        if cfg.nsym == nsym:
            return cfg
    raise ValueError(f"no {fmt!r} MCS {mcs} length gives {nsym} symbols")


def demod_case(conf, nrx: int, B: int, nsym: int | None, seed: int,
               device="cpu", snr_db: float = 25.0):
    """(cfg, xs, data_start, h, pilot_h) on ``device``: :func:`windows` of
    packets of ``conf`` = (fmt, mcs, nss), the twin's channel estimate,
    and the config to demodulate: the packets' own, or one with ``nsym``
    symbols (windows past the packet's end carry noise)."""
    fmt, mcs, nss = conf
    pcfg, x, sigb_gi = windows(fmt, mcs, nss, nrx, B, snr_db, seed)
    cfg = pcfg if nsym is None else cfg_with_nsym(fmt, mcs, nss, nsym)
    ds = _data_start(cfg)
    need = ds + 80 * cfg.nsym + 16
    if x.shape[-1] < need:
        rng = np.random.default_rng(seed + 1)
        pad = 0.05 * (rng.normal(size=(B, nrx, need - x.shape[-1]))
                      + 1j * rng.normal(size=(B, nrx, need - x.shape[-1])))
        x = np.concatenate([x, pad.astype(np.complex64)], axis=-1)
    xs = from_numpy_cf(x, device)
    h, pilot_h = OF.payload_chanest_ref(xs, fmt, pcfg.nltf, nss, sigb_gi)
    return cfg, xs, ds, h, pilot_h


def row_condition(h, legacy: bool = False):
    """(B,) float: each row's largest condition number over the data tones
    of its (nrx, nss) channel ``h`` (B, nrx, nss, 64), 1 for one stream and
    infinite for more streams than antennas; by it the two-stream ZF
    magnifies a perturbation of the received symbols."""
    B, nrx, nss, _ = h.re.shape
    if nss == 1 or nss > nrx:
        return torch.full((B,), 1.0 if nss == 1 else float("inf"),
                          dtype=torch.float64, device=h.re.device)
    d = torch.from_numpy(T.DATA_IDX_L if legacy else T.DATA_IDX_NL).to(
        h.re.device)
    m = torch.complex(h.re[..., d].double(), h.im[..., d].double())
    sv = torch.linalg.svdvals(m.permute(0, 3, 1, 2))      # (B, nsd, 2)
    return (sv[..., 0] / sv[..., -1]).amax(dim=1)
