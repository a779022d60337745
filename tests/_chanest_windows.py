"""Payload windows for the tests of the payload channel estimate (K7 and
its twin, ``ops/ofdm.payload_chanest``): packets of the port's own
transmitter (numpy), each row through its own flat channel to ``nrx``
antennas, AWGN at ``snr_db`` on each antenna, cut 1-7 samples before the
L-LTF (the receive path's ``ltf_idx`` origin aims early into the GI).
Imports neither JAX nor the JAX package."""
from __future__ import annotations

import numpy as np

from gr_ieee80211_tpu_torch.gold import mac, tx
from gr_ieee80211_tpu_torch.models.rx import _data_start
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
