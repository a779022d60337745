"""PHY transmit-vector parameters for 802.11a/n/ac, 20 MHz, <=2 streams.

This is the framework's equivalent of the reference's ``c8p_mod`` /
``modulation`` objects (``lib/cloud80211phy.h:58-132``,
``tools/phy80211header.py:137-525``), re-derived from the
standard's rate tables and TXTIME equations and kept as a frozen dataclass so
configs can key per-config caches and batch buckets.
"""
from __future__ import annotations

import dataclasses
import enum
import math

N_SERVICE = 16
N_TAIL = 6
MAX_PSDU = 4095


class Fmt(enum.IntEnum):
    L = 0
    HT = 1
    VHT = 2


# Per-MCS (modulation order nBPSCS, coding rate) tables.
_L_MCS = {
    0: (1, "1/2"), 1: (1, "3/4"), 2: (2, "1/2"), 3: (2, "3/4"),
    4: (4, "1/2"), 5: (4, "3/4"), 6: (6, "2/3"), 7: (6, "3/4"),
}
_NL_MCS = {
    0: (1, "1/2"), 1: (2, "1/2"), 2: (2, "3/4"), 3: (4, "1/2"),
    4: (4, "3/4"), 5: (6, "2/3"), 6: (6, "3/4"), 7: (6, "5/6"),
    8: (8, "3/4"), 9: (8, "5/6"),
}
_CR_FRAC = {"1/2": (1, 2), "2/3": (2, 3), "3/4": (3, 4), "5/6": (5, 6)}


@dataclasses.dataclass(frozen=True)
class PhyConfig:
    """One transmit vector (format, mcs, streams, payload length).

    ``length`` is the MPDU length for L/HT non-aggregated, or the A-MPDU
    (APEP) length for HT-aggregated and VHT.  VHT with length 0 is an NDP.
    """
    fmt: Fmt
    mcs: int
    nss: int = 1
    length: int = 0
    ampdu: bool = False
    #: For MU-MIMO per-user encoding: force the common MU symbol count.
    mu_nsym: int = 0

    def __post_init__(self):
        if self.fmt == Fmt.L:
            assert 0 <= self.mcs <= 7 and self.nss == 1 and not self.ampdu
        elif self.fmt == Fmt.HT:
            assert 0 <= self.mcs <= 15 and self.nss == self.mcs // 8 + 1
        else:
            assert 0 <= self.mcs <= 8 and self.nss in (1, 2)
        assert self.length <= MAX_PSDU

    # -- rate-dependent geometry ------------------------------------------
    @property
    def nbpscs(self) -> int:
        return (_L_MCS if self.fmt == Fmt.L else _NL_MCS)[self.mcs % 8 if self.fmt == Fmt.HT else self.mcs][0]

    @property
    def cr(self) -> str:
        return (_L_MCS if self.fmt == Fmt.L else _NL_MCS)[self.mcs % 8 if self.fmt == Fmt.HT else self.mcs][1]

    @property
    def nsd(self) -> int:
        return 48 if self.fmt == Fmt.L else 52

    @property
    def ncbpss(self) -> int:
        return self.nsd * self.nbpscs

    @property
    def ncbps(self) -> int:
        return self.ncbpss * self.nss

    @property
    def ndbps(self) -> int:
        num, den = _CR_FRAC[self.cr]
        return self.ncbps * num // den

    @property
    def nes(self) -> int:
        return 1  # 20 MHz <=2SS never exceeds the 300 Mb/s single-encoder bound

    @property
    def nltf(self) -> int:
        return 0 if self.fmt == Fmt.L else int(2 * math.ceil(self.nss / 2)) if self.nss > 1 else 1

    @property
    def is_ndp(self) -> bool:
        return self.fmt == Fmt.VHT and self.length == 0

    # -- packet length derivation (17.4.3, 19.3.11, 21.3.10) ---------------
    @property
    def nsym(self) -> int:
        if self.mu_nsym:
            return self.mu_nsym
        if self.is_ndp:
            return 0
        bits = 8 * self.length + N_SERVICE + N_TAIL * self.nes
        return math.ceil(bits / self.ndbps)

    @property
    def psdu_len(self) -> int:
        """Bytes carried in the data field (VHT pads the A-MPDU up)."""
        if self.fmt != Fmt.VHT:
            return self.length
        if self.is_ndp and not self.mu_nsym:
            return 0
        return (self.nsym * self.ndbps - N_SERVICE - N_TAIL * self.nes) // 8

    @property
    def n_pad_eof(self) -> int:
        return 0 if self.fmt != Fmt.VHT else (self.psdu_len - self.length) // 4

    @property
    def n_pad_octet(self) -> int:
        return 0 if self.fmt != Fmt.VHT else self.psdu_len - self.length - 4 * self.n_pad_eof

    @property
    def n_pad_bits(self) -> int:
        if self.is_ndp:
            return 0
        return self.nsym * self.ndbps - 8 * self.psdu_len - N_SERVICE - N_TAIL * self.nes

    @property
    def tx_time_us(self) -> int:
        if self.fmt == Fmt.L:
            return 20 + 4 * self.nsym
        if self.fmt == Fmt.HT:
            return 20 + 8 + 4 + 4 * self.nltf + 4 * self.nsym
        return 20 + 8 + 4 + 4 * self.nltf + 4 + 4 * self.nsym

    @property
    def legacy_len(self) -> int:
        """Spoofed L-SIG LENGTH so legacy devices defer for the whole PPDU."""
        if self.fmt == Fmt.L:
            return self.length
        return (self.tx_time_us - 20) // 4 * 3 - 3

    @property
    def legacy_nsym(self) -> int:
        """Number of 4us symbol slots a third party infers from L-SIG (6 Mb/s)."""
        if self.fmt == Fmt.L:
            return self.nsym
        return math.ceil((22 + 8 * self.legacy_len) / 24)

    @property
    def n_trellis(self) -> int:
        """Viterbi trellis steps for the data field (input bits incl. tail)."""
        return self.nsym * self.ndbps

    @property
    def n_samples(self) -> int:
        """Baseband samples at 20 Msps for the full PPDU."""
        n = 320 + 80  # L-STF+L-LTF, L-SIG
        if self.fmt == Fmt.HT:
            n += 160 + 80 + 80 * self.nltf  # HT-SIG, HT-STF, HT-LTFs
        elif self.fmt == Fmt.VHT:
            n += 160 + 80 + 80 * self.nltf + 80  # SIG-A, STF, LTFs, SIG-B
        return n + 80 * self.nsym

    @property
    def data_rate_mbps(self) -> float:
        return self.ndbps / 4.0


@dataclasses.dataclass(frozen=True)
class MuConfig:
    """VHT MU-MIMO downlink transmit vector (2 users, 1 stream each)."""
    users: tuple[PhyConfig, ...]
    group_id: int = 1

    def __post_init__(self):
        assert 2 <= len(self.users) <= 4
        for u in self.users:
            assert u.fmt == Fmt.VHT

    @property
    def nss_total(self) -> int:
        return sum(u.nss for u in self.users)

    @property
    def nsym(self) -> int:
        return max(u.nsym for u in self.users)

    @property
    def nltf(self) -> int:
        return int(2 * math.ceil(self.nss_total / 2))

    @property
    def tx_time_us(self) -> int:
        return 20 + 8 + 4 + 4 * self.nltf + 4 + 4 * self.nsym

    @property
    def legacy_len(self) -> int:
        return (self.tx_time_us - 20) // 4 * 3 - 3

    def user_padded(self, u: int) -> PhyConfig:
        """Per-user view padded to the common MU symbol count."""
        return dataclasses.replace(self.users[u], mu_nsym=self.nsym)

    @property
    def n_samples(self) -> int:
        return 320 + 80 + 160 + 80 + 80 * self.nltf + 80 + 80 * self.nsym

