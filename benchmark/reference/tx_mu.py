"""The MU-MIMO downlink of the reference transmitter: the MU VHT-SIG-B bits,
the 2-user MU PPDU with its per-subcarrier spatial mapping Q, and the
sounding that makes Q (an NDP channel estimate turned into a feedback row,
then zero forcing over the stations' rows).

Frozen numpy copies of ``gr_ieee80211_tpu_torch/gold/sig.vhtsigb_bits_mu``,
``gold/tx.tx_waveform_mu`` and ``gold/sounding.{interp_pilot_tones,
feedback_from_ndp, zf_q, q_to_grid}`` (IEEE Std 802.11-2020 21.3.8.3.6,
21.3.10; the AP side of GR-WiFi's ``tools/cmu_v3/cmu_ap.py``: raw channel
feedback and a ZF precoder), built from ``tx.py``'s parts.  Nothing here
imports the program, torch or JAX.
"""
from __future__ import annotations

import numpy as np

from . import sig as S
from . import tables as T
from .params import Fmt, MuConfig, PhyConfig
from .tx import (_apply_csd, _apply_q, _dual_sym_sig, _time_sym,
                 data_field, data_field_bits, data_pilots, encode_data_bits,
                 interleave_sigb, legacy_training, lsig_field,
                 modulate_data_symbols, nl_training, window_concat)


def _num_bits(v: int, n: int) -> list[int]:
    return [(v >> i) & 1 for i in range(n)]


def vhtsigb_bits_mu(user_cfg: PhyConfig) -> tuple[np.ndarray, np.ndarray]:
    """26 VHT-SIG-B bits for one MU user: LENGTH/4 (16), MCS (4), tail (6);
    and the CRC-8 of the 20 body bits, which the SERVICE field carries."""
    body = _num_bits(user_cfg.length // 4, 16) + _num_bits(user_cfg.mcs, 4)
    crc = T.crc8_bits(body)
    return np.array(body + [0] * 6, dtype=np.uint8), crc


def tx_waveform_mu(mu: MuConfig, payloads: list[bytes], bfq: np.ndarray,
                   seed: int = 93) -> np.ndarray:
    """A VHT MU PPDU at the AP's antennas, (nss_total, n_samples).

    ``payloads``: each user's A-MPDU; ``bfq``: (64, ntx, nss_total) spatial
    mapping, applied to the VHT-STF, VHT-LTFs, VHT-SIG-B and data.  Each
    user's data is encoded at its own MCS and padded to the PPDU's common
    symbol count; the streams are stacked in user order."""
    nss = mu.nss_total
    base = PhyConfig(Fmt.VHT, 0, nss, 4, mu_nsym=mu.nsym)  # geometry carrier
    chunks = legacy_training(nss) + [lsig_field(mu, nss)]
    chunks += _dual_sym_sig(S.vhtsiga_bits(mu), nss, qbpsk_first=False)
    chunks += nl_training(nss, mu.nltf, Fmt.VHT, bfq=bfq)
    sigb_streams, crcs = [], []
    for ucfg in mu.users:
        sigb, crc = vhtsigb_bits_mu(ucfg)
        crcs.append(crc)
        inted = interleave_sigb(sigb)
        for _ in range(ucfg.nss):
            sigb_streams.append(T.qam_table(1)[inted])
    grids = np.zeros((nss, 64), dtype=np.complex128)
    for iss in range(nss):
        grids[iss, T.DATA_IDX_NL] = sigb_streams[iss]
        grids[iss, T.PILOT_IDX] = T.PILOT_VHT
    grids = _apply_q(_apply_csd(grids, nss, False), bfq)
    chunks.append(_time_sym(grids, T.NTF_SIGB, nss))
    all_syms = []
    for u in range(len(mu.users)):
        ucfg_p = mu.user_padded(u)
        data_bits = data_field_bits(ucfg_p, payloads[u], crcs[u])
        coded = encode_data_bits(ucfg_p, data_bits, seed)
        all_syms.append(modulate_data_symbols(ucfg_p, coded))
    symbols = np.concatenate(all_syms, axis=0)       # (nss_total, nsym, 52)
    pilots = data_pilots(Fmt.VHT, nss, mu.nsym)
    chunks += data_field(base, symbols, bfq=bfq, pilots=pilots)
    return window_concat(chunks)


# ---------------------------------------------------------------------------
# sounding: NDP estimate -> feedback row -> ZF Q
# ---------------------------------------------------------------------------

def interp_pilot_tones(h_data: np.ndarray) -> np.ndarray:
    """The 4 pilot tones from their neighbours, magnitude and (wrap-aware)
    phase averaged: (..., 52) data tones -> (..., 56) occupied tones."""
    mag = np.abs(h_data)
    ph = np.angle(h_data)

    def mid(i, j):
        d = ph[..., j: j + 1] - ph[..., i: i + 1]
        d = d - 2 * np.pi * np.round(d / (2 * np.pi))
        m = (mag[..., i: i + 1] + mag[..., j: j + 1]) / 2
        return m * np.exp(1j * (ph[..., i: i + 1] + d / 2))

    return np.concatenate([
        h_data[..., 0:7], mid(6, 7),
        h_data[..., 7:20], mid(19, 20),
        h_data[..., 20:32], mid(31, 32),
        h_data[..., 32:45], mid(44, 45),
        h_data[..., 45:52]], axis=-1)


def feedback_from_ndp(ndp_chan: np.ndarray) -> np.ndarray:
    """A station's feedback: its (nrx, nsts, 64) NDP estimate over the
    occupied tones with each stream's cyclic shift taken off and the pilot
    tones interpolated, (nrx, nsts, 56)."""
    _, nsts, _ = ndp_chan.shape
    h = ndp_chan[:, :, T.DATA_IDX_NL].copy()
    for s in range(nsts):
        ramp = T.csd_phase(T.CSD_NL_NS[nsts - 1][s])[T.DATA_IDX_NL]
        h[:, s] = h[:, s] / ramp
    return interp_pilot_tones(h)


def zf_q(h_rows: np.ndarray) -> np.ndarray:
    """Per-subcarrier ZF precoder from the stations' stacked channel rows
    (n_sts_total, ntx, nsc): Q (nsc, ntx, n_sts) with H Q = c I and
    ||Q||_F = sqrt(n_sts) at each subcarrier."""
    nsts = h_rows.shape[0]
    H = h_rows.transpose(2, 0, 1)                       # (nsc, nsts, ntx)
    Hh = np.conj(H.transpose(0, 2, 1))
    q = Hh @ np.linalg.inv(H @ Hh)
    norm = np.linalg.norm(q, axis=(1, 2), keepdims=True)
    return q / norm * np.sqrt(nsts)


def q_to_grid(q56: np.ndarray) -> np.ndarray:
    """(56, ntx, nsts) occupied-tone Q -> (64, ntx, nsts), the identity on
    the unused bins."""
    _, ntx, nsts = q56.shape
    out = np.tile(np.eye(ntx, nsts, dtype=complex), (64, 1, 1))
    out[T.OCC_IDX_NL] = q56
    return out
