"""MAC layer, the transmit side the benchmark's traffic needs: QoS data
frames with their FCS and HT/VHT A-MPDU aggregation with 4-byte delimiters
(the reference PY-TB MAC toolbox, ``tools/mac80211.py``).
"""
from __future__ import annotations

import struct
import numpy as np

from . import tables as T
from .bits import fcs32


def _mac_addr(a: str) -> bytes:
    return bytes(int(x, 16) for x in a.split(":"))


def qos_data_frame(payload: bytes, addr1: str, addr2: str, addr3: str,
                   seq: int, to_ds: int = 1, from_ds: int = 0,
                   duration: int = 110) -> bytes:
    """MPDU: | FC | dur | a1 | a2 | a1 | seq | QoS | payload | FCS |.

    Note the reference transmits addr1 twice (phy80211 wire behavior we keep
    for interop); QoS control field is zero.
    """
    fc = (2 << 2) | (8 << 4) | (to_ds << 8) | (from_ds << 9)
    hdr = struct.pack("<HH", fc, duration)
    hdr += _mac_addr(addr1) + _mac_addr(addr2) + _mac_addr(addr1)
    hdr += struct.pack("<H", seq << 4)
    hdr += struct.pack("<H", 0)
    body = hdr + payload
    return body + fcs32(body)


# ---------------------------------------------------------------------------
# A-MPDU aggregation (9.7) and deaggregation
# ---------------------------------------------------------------------------

def _delim_bytes(bits: np.ndarray) -> bytes:
    return T.bits_to_bytes(bits)


def ampdu_aggregate_ht(mpdus: list[bytes]) -> bytes:
    """HT A-MPDU: [delim(4) | mpdu | pad-to-4]*; 12-bit length field."""
    out = b""
    for i, m in enumerate(mpdus):
        assert 1 <= len(m) <= 4095
        head = np.zeros(16, dtype=np.uint8)
        head[4:16] = [(len(m) >> j) & 1 for j in range(12)]
        bits = np.concatenate([head, T.crc8_bits(head),
                               np.unpackbits(np.array([0x4E], np.uint8), bitorder="little")])
        sub = _delim_bytes(bits) + m
        if i < len(mpdus) - 1:
            sub += b"\x00" * (-len(sub) % 4)
        out += sub
    return out


def ampdu_aggregate_vht(mpdus: list[bytes]) -> bytes:
    """VHT A-MPDU: eof flag set when a single MPDU; 14-bit length; pad all."""
    out = b""
    for m in mpdus:
        eof = 1 if len(mpdus) == 1 else 0
        head = np.zeros(16, dtype=np.uint8)
        head[0] = eof
        lenbits = [(len(m) >> j) & 1 for j in range(14)]
        head[2:4] = lenbits[12:14]
        head[4:16] = lenbits[0:12]
        bits = np.concatenate([head, T.crc8_bits(head),
                               np.unpackbits(np.array([0x4E], np.uint8), bitorder="little")])
        sub = _delim_bytes(bits) + m
        sub += b"\x00" * (-len(sub) % 4)
        out += sub
    return out


# ---------------------------------------------------------------------------
# Frame parsing / pretty printing (mac80211header.pktParser:833 parity)
# ---------------------------------------------------------------------------

TYPE_NAMES = {0: "Management", 1: "Control", 2: "Data", 3: "Extension"}
SUBTYPE_NAMES = {
    (0, 8): "Beacon", (0, 13): "Action", (0, 14): "Action No Ack",
    (1, 4): "Beamforming Report Poll", (1, 5): "VHT NDP Announcement",
    (1, 8): "Block Ack Req", (1, 9): "Block Ack", (1, 11): "RTS",
    (1, 12): "CTS", (1, 13): "ACK",
    (2, 0): "Data", (2, 4): "Null", (2, 8): "QoS Data", (2, 12): "QoS Null",
}


MGMT_ELEMENT_NAMES = {0: "SSID", 1: "Supported Rates", 3: "DS Parameter",
                      5: "TIM", 7: "Country", 32: "Power Constraint",
                      45: "HT Capabilities", 61: "HT Operation",
                      48: "RSN", 191: "VHT Capabilities",
                      192: "VHT Operation", 221: "Vendor Specific"}


