"""SIGNAL field bit generation (L-SIG / HT-SIG / VHT-SIG-A / VHT-SIG-B).

Behavioral parity targets: ``lib/cloud80211phy.cc:650-1328,
2944-3161`` and ``tools/phy80211.py:237-456,512-637``.
"""
from __future__ import annotations

import numpy as np

from . import tables as T
from .params import Fmt, PhyConfig, MuConfig

#: L-SIG RATE bits (LSB-first on air) for legacy MCS 0..7 (table 17-6).
LEGACY_RATE_BITS = np.array(
    [[1, 1, 0, 1], [1, 1, 1, 1], [0, 1, 0, 1], [0, 1, 1, 1],
     [1, 0, 0, 1], [1, 0, 1, 1], [0, 0, 0, 1], [0, 0, 1, 1]], dtype=np.uint8)


def _num_bits(v: int, n: int) -> list[int]:
    return [(v >> i) & 1 for i in range(n)]


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def lsig_bits(cfg) -> np.ndarray:
    """24 L-SIG bits: RATE(4), reserved, LENGTH(12), parity, tail(6)."""
    mcs = cfg.mcs if getattr(cfg, "fmt", None) == Fmt.L else 0
    bits = list(LEGACY_RATE_BITS[mcs]) + [0] + _num_bits(cfg.legacy_len, 12)
    bits.append(sum(bits) % 2)
    return np.array(bits + [0] * 6, dtype=np.uint8)


def htsig_bits(cfg: PhyConfig) -> np.ndarray:
    """48 HT-SIG bits (19.3.9.4.3), 20 MHz, BCC, long GI."""
    bits = _num_bits(cfg.mcs, 7) + [0]                      # mcs, 20 MHz
    bits += _num_bits(cfg.psdu_len, 16)
    bits += [1, 1, 1]                                       # smoothing, not-sounding, rsvd
    bits += [1 if cfg.ampdu else 0]
    bits += [0, 0, 0, 0]                                    # stbc(2), bcc, short gi
    bits += [0, 0]                                          # n extension ss
    bits = bits + list(T.crc8_bits(bits))
    return np.array(bits + [0] * 6, dtype=np.uint8)


def vhtsiga_bits(cfg: PhyConfig | MuConfig, group_id: int = 0,
                 partial_aid: int = 0) -> np.ndarray:
    """48 VHT-SIG-A bits (21.3.8.3.3), 20 MHz, BCC, long GI."""
    mu = isinstance(cfg, MuConfig)
    bits = [0, 0, 1, 0]                                     # bw 20, rsvd, stbc 0
    gid = cfg.group_id if mu else group_id
    bits += _num_bits(gid, 6)
    if mu:
        for u in cfg.users:
            bits += _num_bits(u.nss, 3)
        bits += [0] * 3 * (4 - len(cfg.users))
    else:
        bits += _num_bits(cfg.nss - 1, 3)
        bits += _num_bits(partial_aid, 9)
    bits += [0, 1]                                          # txop ps, rsvd
    bits += [0, 0]                                          # short gi, sgi disamb
    bits += [0, 0]                                          # coding(u0) bcc, ldpc extra
    if mu:
        bits += [0] * (len(cfg.users) - 1)                  # users 1.. coding bcc
        bits += [1] * (4 - len(cfg.users))                  # reserved coding slots
        bits += [1, 1]                                      # rsvd, beamformed rsvd
    else:
        bits += _num_bits(cfg.mcs, 4)
        bits += [0]                                         # beamformed
    bits += [1]                                             # reserved
    bits = bits + list(T.crc8_bits(bits))
    return np.array(bits + [0] * 6, dtype=np.uint8)


def vhtsigb_bits(cfg: PhyConfig) -> tuple[np.ndarray, np.ndarray]:
    """26 VHT-SIG-B bits (SU 20 MHz) and the 8 CRC bits folded into SERVICE."""
    if cfg.is_ndp:
        return np.concatenate([T.NDP_SIGB_20, np.zeros(6, np.uint8)]), np.zeros(8, np.uint8)
    body = _num_bits(-(-cfg.length // 4), 17) + [1, 1, 1]
    crc = T.crc8_bits(body)
    return np.array(body + [0] * 6, dtype=np.uint8), crc


# ---------------------------------------------------------------------------
# Checking / parsing (RX side)
# ---------------------------------------------------------------------------

_RATE_TO_MCS = {tuple(LEGACY_RATE_BITS[m]): m for m in range(8)}
_L_NDBPS = [24, 36, 48, 72, 96, 144, 192, 216]


