"""SIGNAL field bit generation, checking and parsing (L-SIG / HT-SIG /
VHT-SIG-A / VHT-SIG-B).

Behavioral parity targets: ``lib/cloud80211phy.cc:650-1328,
2944-3161`` and ``tools/phy80211.py:237-456,512-637``.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from ..spec import tables as T
from ..spec.params import Fmt, PhyConfig, MuConfig

#: L-SIG RATE bits (LSB-first on air) for legacy MCS 0..7 (table 17-6).
LEGACY_RATE_BITS = np.array(
    [[1, 1, 0, 1], [1, 1, 1, 1], [0, 1, 0, 1], [0, 1, 1, 1],
     [1, 0, 0, 1], [1, 0, 1, 1], [0, 0, 0, 1], [0, 0, 1, 1]], dtype=np.uint8)


def _num_bits(v: int, n: int) -> list[int]:
    return [(v >> i) & 1 for i in range(n)]


def _bits_num(bits) -> int:
    return int(sum(int(b) << i for i, b in enumerate(bits)))


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


def vhtsigb_bits_mu(user_cfg: PhyConfig) -> tuple[np.ndarray, np.ndarray]:
    """26 VHT-SIG-B bits for one MU user: LEN(16), MCS(4), tail(6)."""
    body = _num_bits(user_cfg.length // 4, 16) + _num_bits(user_cfg.mcs, 4)
    crc = T.crc8_bits(body)
    return np.array(body + [0] * 6, dtype=np.uint8), crc


# ---------------------------------------------------------------------------
# Checking / parsing (RX side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LSigInfo:
    ok: bool
    mcs: int = 0
    length: int = 0
    nsym: int = 0


_RATE_TO_MCS = {tuple(LEGACY_RATE_BITS[m]): m for m in range(8)}
_L_NDBPS = [24, 36, 48, 72, 96, 144, 192, 216]


def parse_lsig(bits: np.ndarray) -> LSigInfo:
    bits = np.asarray(bits, dtype=np.uint8)
    if bits[4] != 0 or int(bits[:17].sum()) % 2 != int(bits[17]) or bits[18:24].any():
        return LSigInfo(False)
    key = tuple(int(b) for b in bits[:4])
    if key not in _RATE_TO_MCS:
        return LSigInfo(False)
    mcs = _RATE_TO_MCS[key]
    length = _bits_num(bits[5:17])
    if not (14 <= length <= 4095):
        return LSigInfo(False)
    nsym = -(-(22 + 8 * length) // _L_NDBPS[mcs])
    return LSigInfo(True, mcs, length, nsym)


@dataclasses.dataclass
class HtSigInfo:
    ok: bool
    mcs: int = 0
    length: int = 0
    ampdu: bool = False
    short_gi: bool = False


def parse_htsig(bits: np.ndarray) -> HtSigInfo:
    bits = np.asarray(bits, dtype=np.uint8)
    if bits[26] != 1:  # reserved must be 1
        return HtSigInfo(False)
    if not np.array_equal(T.crc8_bits(bits[:34]), bits[34:42]) or bits[42:48].any():
        return HtSigInfo(False)
    mcs = _bits_num(bits[0:7])
    if bits[7] != 0 or mcs > 15:        # 20 MHz, <=2SS only
        return HtSigInfo(False)
    length = _bits_num(bits[8:24])
    if bits[28] or bits[29] or bits[30]:  # STBC / LDPC unsupported
        return HtSigInfo(False)
    if bits[32] or bits[33]:            # extension spatial streams unsupported
        return HtSigInfo(False)         # (signalCheckHt, cloud80211phy.cc:744)
    return HtSigInfo(True, mcs, length, bool(bits[27]), bool(bits[31]))


@dataclasses.dataclass
class VhtSigAInfo:
    ok: bool
    group_id: int = 0
    mu: bool = False
    nsts: tuple = (0, 0, 0, 0)
    nss: int = 0
    mcs: int = 0
    partial_aid: int = 0


def parse_vhtsiga(bits: np.ndarray) -> VhtSigAInfo:
    bits = np.asarray(bits, dtype=np.uint8)
    if bits[2] != 1 or bits[23] != 1 or bits[33] != 1:
        return VhtSigAInfo(False)
    if not np.array_equal(T.crc8_bits(bits[:34]), bits[34:42]) or bits[42:48].any():
        return VhtSigAInfo(False)
    if bits[0] or bits[1]:              # 20 MHz only
        return VhtSigAInfo(False)
    if bits[3]:                         # STBC unsupported
        return VhtSigAInfo(False)
    gid = _bits_num(bits[4:10])
    mu = gid not in (0, 63)
    if mu:
        nsts = tuple(_bits_num(bits[10 + 3 * u: 13 + 3 * u]) for u in range(4))
        return VhtSigAInfo(True, gid, True, nsts)
    nss = _bits_num(bits[10:13]) + 1
    partial_aid = _bits_num(bits[13:22])
    mcs = _bits_num(bits[28:32])
    return VhtSigAInfo(True, gid, False, (nss, 0, 0, 0), nss, mcs, partial_aid)


@dataclasses.dataclass
class VhtSigBInfo:
    ok: bool
    length: int = 0     # APEP length in bytes (x4 granularity)
    mcs: int = -1       # MU only
    crc: np.ndarray = None


def parse_vhtsigb(bits: np.ndarray, mu: bool = False) -> VhtSigBInfo:
    """Parse the 26 decoded VHT-SIG-B bits (20 MHz).

    Structural validation: the 6 tail bits must decode to zero, and for SU
    the 3 reserved bits (17..19) must be all-ones (21.3.8.3.6).  The CRC over
    the 20-bit body is returned for the caller's SERVICE-field cross-check
    (the reference does the same re-encode comparison, demod_impl.cc:449-505).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    body = bits[:20]
    crc = T.crc8_bits(body)
    if bits[20:26].any():
        return VhtSigBInfo(False, crc=crc)
    if mu:
        return VhtSigBInfo(True, _bits_num(bits[0:16]) * 4,
                           _bits_num(bits[16:20]), crc)
    if not (bits[17] and bits[18] and bits[19]):
        return VhtSigBInfo(False, crc=crc)
    return VhtSigBInfo(True, _bits_num(bits[0:17]) * 4, -1, crc)
