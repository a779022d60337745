"""MAC layer: frame construction, A-MPDU (de)aggregation, FCS.

Covers the reference PY-TB MAC toolbox behavior
(``tools/mac80211.py``): QoS data frames with LLC/IPv4/UDP
encapsulation, HT/VHT A-MPDU aggregation with 4-byte delimiters, VHT NDP
Announcement / Beamforming Report Poll control frames, and action-no-ack
management frames carrying compressed beamforming reports.  Plus the RX-side
deaggregation walk performed by the reference decoder
(``lib/decode_impl.cc:325-427``).
"""
from __future__ import annotations

import dataclasses
import struct
import numpy as np

from ..spec import tables as T
from .bits import fcs32, fcs_ok


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


def data_frame(payload: bytes, addr1: str, addr2: str, addr3: str,
               seq: int, to_ds: int = 1, from_ds: int = 0,
               duration: int = 110) -> bytes:
    """Plain (non-QoS) Data MPDU, subtype 0 — no QoS control field.

    Mirrors mac80211.mac80211(2, 0, ...).genPacket
    (tools/mac80211.py) as used by pktGenOwExample.py.
    """
    fc = (2 << 2) | (0 << 4) | (to_ds << 8) | (from_ds << 9)
    hdr = struct.pack("<HH", fc, duration)
    hdr += _mac_addr(addr1) + _mac_addr(addr2) + _mac_addr(addr1)
    hdr += struct.pack("<H", seq << 4)
    body = hdr + payload
    return body + fcs32(body)


def llc_ip_udp(payload: bytes, s_ip: str, d_ip: str, s_port: int, d_port: int,
               ip_id: int = 0, ttl: int = 64) -> bytes:
    """LLC/SNAP + IPv4 + UDP encapsulation (checksums computed)."""
    import socket as _s

    udp_len = len(payload) + 8

    def csum16(total: int) -> int:
        while total > 0xFFFF:
            total = (total & 0xFFFF) + (total >> 16)
        return 0xFFFF - total

    sip, dip = _s.inet_aton(s_ip), _s.inet_aton(d_ip)
    acc = sum(struct.unpack(">2H", sip)) + sum(struct.unpack(">2H", dip))
    acc += _s.IPPROTO_UDP + udp_len + s_port + d_port + udp_len
    pp = payload + (b"\x00" if len(payload) % 2 else b"")
    acc += sum(struct.unpack(f">{len(pp)//2}H", pp))
    udp_hdr = struct.pack(">HHHH", s_port, d_port, udp_len, csum16(acc))

    ip_len = 20 + udp_len
    ver_ihl = 0x4500
    flags = 2 << 13  # DF
    acc = ver_ihl + ip_len + ip_id + flags + (ttl << 8) + _s.IPPROTO_UDP
    acc += sum(struct.unpack(">2H", sip)) + sum(struct.unpack(">2H", dip))
    ip_hdr = struct.pack(">HHHHHH", ver_ihl, ip_len, ip_id, flags,
                         (ttl << 8) + _s.IPPROTO_UDP, csum16(acc)) + sip + dip

    llc = bytes([0xAA, 0xAA, 0x03, 0, 0, 0]) + struct.pack(">H", 0x0800)
    return llc + ip_hdr + udp_hdr + payload


def ndp_announcement(rx_addr: str, tx_addr: str, token: int,
                     sta_aids: list[int], sta_fb_type: list[int]) -> bytes:
    """VHT NDP Announcement control frame (9.3.1.19)."""
    fc = (1 << 2) | (5 << 4)
    pkt = struct.pack("<HH", fc, 340)
    pkt += _mac_addr(rx_addr) + _mac_addr(tx_addr)
    pkt += struct.pack("<B", token << 2)
    for aid, fb in zip(sta_aids, sta_fb_type):
        pkt += struct.pack("<H", aid | (fb << 12))
    return pkt + fcs32(pkt)


def bf_report_poll(rx_addr: str, tx_addr: str, segments: list[int]) -> bytes:
    fc = (1 << 2) | (4 << 4)
    pkt = struct.pack("<HH", fc, 110)
    pkt += _mac_addr(rx_addr) + _mac_addr(tx_addr)
    bitmap = 0
    for s in segments:
        bitmap |= 1 << s
    pkt += struct.pack("<B", bitmap)
    return pkt + fcs32(pkt)


def action_no_ack(ds_addr: str, tx_addr: str, bssid: str, seq: int,
                  category: int, details: bytes) -> bytes:
    """Management action-no-ack frame (carries BF reports)."""
    fc = (0 << 2) | (14 << 4)
    pkt = struct.pack("<HH", fc, 32)
    pkt += _mac_addr(ds_addr) + _mac_addr(tx_addr) + _mac_addr(bssid)
    pkt += struct.pack("<H", seq) + struct.pack("<B", category) + details
    return pkt + fcs32(pkt)


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


@dataclasses.dataclass
class Delim:
    ok: bool
    eof: int = 0
    length: int = 0


def parse_delimiter(delim: bytes) -> Delim:
    """Parse a 4-byte VHT A-MPDU delimiter (bits LSB-first per byte)."""
    if len(delim) < 4 or delim[3] != 0x4E:
        return Delim(False)
    bits = T.bytes_to_bits(delim[:2])
    if not np.array_equal(T.crc8_bits(bits), T.bytes_to_bits(delim[2:3])):
        return Delim(False)
    eof = int(bits[0])
    length = sum(int(bits[4 + j]) << j for j in range(12))
    length |= (int(bits[2]) << 12) | (int(bits[3]) << 13)
    return Delim(True, eof, length)


def ampdu_deaggregate(psdu: bytes, ht: bool = False) -> list[bytes]:
    """Walk delimiters, return MPDUs whose FCS passes (reference decode walk)."""
    out = []
    pos = 0
    n = len(psdu)
    while pos + 4 <= n:
        d = parse_delimiter(psdu[pos: pos + 4])
        if not d.ok:
            pos += 4
            continue
        if d.length == 0:  # EOF padding subframe
            pos += 4
            continue
        mpdu = psdu[pos + 4: pos + 4 + d.length]
        if len(mpdu) == d.length and fcs_ok(mpdu):
            out.append(mpdu)
        pos += 4 + d.length
        pos += -pos % 4
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


@dataclasses.dataclass
class FrameInfo:
    ok: bool                      # FCS valid
    ftype: int = 0
    subtype: int = 0
    to_ds: int = 0
    from_ds: int = 0
    retry: int = 0
    protected: int = 0
    duration: int = 0
    addr1: str = ""
    addr2: str = ""
    addr3: str = ""
    seq: int = 0
    frag: int = 0
    qos: int | None = None
    body: bytes = b""

    @property
    def name(self) -> str:
        return SUBTYPE_NAMES.get((self.ftype, self.subtype),
                                 TYPE_NAMES.get(self.ftype, "?"))


def _addr_str(b: bytes) -> str:
    return ":".join(f"{x:02x}" for x in b)


def parse_frame(mpdu: bytes) -> FrameInfo:
    """Parse an MPDU header (+FCS check).  Control frames have shorter
    headers; body excludes the 4-byte FCS."""
    if len(mpdu) < 14:
        return FrameInfo(False)
    fc = mpdu[0] | (mpdu[1] << 8)
    info = FrameInfo(
        ok=fcs32(mpdu[:-4]) == mpdu[-4:],
        ftype=(fc >> 2) & 3, subtype=(fc >> 4) & 0xF,
        to_ds=(fc >> 8) & 1, from_ds=(fc >> 9) & 1,
        retry=(fc >> 11) & 1, protected=(fc >> 14) & 1,
        duration=mpdu[2] | (mpdu[3] << 8),
        addr1=_addr_str(mpdu[4:10]))
    if info.ftype == 1:           # control: a1 (+a2 for some subtypes)
        if len(mpdu) >= 20:
            info.addr2 = _addr_str(mpdu[10:16])
        info.body = mpdu[16:-4] if len(mpdu) > 20 else b""
        return info
    if len(mpdu) < 28:
        return dataclasses.replace(info, ok=False)
    info.addr2 = _addr_str(mpdu[10:16])
    info.addr3 = _addr_str(mpdu[16:22])
    sc = mpdu[22] | (mpdu[23] << 8)
    info.seq, info.frag = sc >> 4, sc & 0xF
    o = 24
    if info.ftype == 2 and info.subtype & 8:     # QoS data
        info.qos = mpdu[24] | (mpdu[25] << 8)
        o = 26
    info.body = mpdu[o:-4]
    return info


def describe_frame(mpdu: bytes) -> str:
    """One-line human description (the reference pktParser console role)."""
    f = parse_frame(mpdu)
    s = (f"{f.name} [{'ok' if f.ok else 'BAD FCS'}] len={len(mpdu)} "
         f"a1={f.addr1}")
    if f.addr2:
        s += f" a2={f.addr2}"
    if f.ftype != 1:
        s += f" seq={f.seq}"
    if f.qos is not None:
        s += f" tid={f.qos & 0xF}"
    if f.ftype == 0 and f.subtype == 14 and f.body[:1] == b"\x15":
        s += " (VHT action: compressed beamforming)"
    return s


MGMT_ELEMENT_NAMES = {0: "SSID", 1: "Supported Rates", 3: "DS Parameter",
                      5: "TIM", 7: "Country", 32: "Power Constraint",
                      45: "HT Capabilities", 61: "HT Operation",
                      48: "RSN", 191: "VHT Capabilities",
                      192: "VHT Operation", 221: "Vendor Specific"}


def parse_mgmt_elements(body: bytes, skip_fixed: int = 12):
    """Parse management-frame information elements.

    body: frame body (for a beacon the first 12 bytes are timestamp +
    interval + capabilities — skipped by default).  Returns a list of
    (element_id, name, payload bytes); SSID decodes to str.  Mirrors
    mac80211header.mgmtElementParser (tools/
    mac80211header.py:733+).
    """
    out = []
    i = skip_fixed
    n = len(body)
    while i + 2 <= n:
        eid, ln = body[i], body[i + 1]
        data = body[i + 2: i + 2 + ln]
        if len(data) < ln:
            break
        if eid == 0:
            try:
                data = data.decode()
            except UnicodeDecodeError:
                pass
        out.append((eid, MGMT_ELEMENT_NAMES.get(eid, f"Element {eid}"), data))
        i += 2 + ln
    return out
