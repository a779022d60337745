"""UDP MAC<->PHY control plane, wire-compatible with the reference.

Copy of ``gr_ieee80211_tpu.runtime.udp_phy``: the wire format and
``PhyRxReporter`` as they are; ``PhyTxServer`` synthesizes with the
port's numpy gold model or, with ``device_tx=True``, the port's batched
``models.tx.TxEngine`` on ``device``.

The reference's runtime API is a pair of localhost UDP sockets
(``examples/tx.grc``: Socket PDU UDP_SERVER :9528 for MAC->PHY transmit
requests; ``rx.grc``: :9527 for PHY->MAC decoded packets).  Formats
(``tools/phy80211.py:1126-1177``, ``lib/pktgen_impl.cc:95-115``,
``lib/decode_impl.cc:100-121,412-419``):

MAC -> PHY (:9528), one datagram per request:
  [fmt, mcs, nss, len_lo, len_hi] + psdu            data (fmt 0/1/2)
  [3, mcs0, nss0, len0x2, mcs1, nss1, len1x2, gid] + psdu0 + psdu1   MU
  [10] + 256 cf32 (2048 B)                          per-bin 2x2 BFQ
  [2, 0, 2, 0, 0]                                   VHT NDP (len 0)

PHY -> MAC (:9527):
  [fmt, len_lo, len_hi] + payload + [mcs]           decoded packet
  [20, 0, 4] + 256 cf32 (1024 B)                    NDP 2x1 channel report

``macExampleGrTx.py`` / ``macExampleGrRx.py`` / the cmu_v3 scripts from the
reference can run unmodified against these servers.
"""
from __future__ import annotations

import socket
import sys
import threading

import numpy as np

from ..spec.params import Fmt, PhyConfig, MuConfig

PHY_TO_MAC_PORT = 9527
MAC_TO_PHY_PORT = 9528

F_MU = 3
F_BFQ = 10
F_NDP_CHAN = 20


class TxRequest:
    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.__dict__.update(kw)


def parse_mac_to_phy(data: bytes) -> TxRequest | None:
    """Parse one MAC->PHY datagram into a transmit request."""
    if len(data) < 1:
        return None
    fmt = data[0]
    if fmt == F_BFQ:
        if len(data) < 1 + 2048:
            return None
        q = np.frombuffer(data[1:2049], dtype=np.float32).reshape(64, 2, 2, 2)
        bfq = q[..., 0] + 1j * q[..., 1]
        return TxRequest("bfq", bfq=bfq)
    if fmt == F_MU:
        if len(data) < 10:
            return None
        mcs0, nss0 = data[1], data[2]
        len0 = data[3] | (data[4] << 8)
        mcs1, nss1 = data[5], data[6]
        len1 = data[7] | (data[8] << 8)
        gid = data[9]
        p0 = data[10: 10 + len0]
        p1 = data[10 + len0: 10 + len0 + len1]
        if len(p0) != len0 or len(p1) != len1:
            return None
        return TxRequest("mu", mcs=(mcs0, mcs1), nss=(nss0, nss1),
                         payloads=(p0, p1), group_id=gid)
    if len(data) < 5 or fmt > 2:
        return None
    mcs, nss = data[1], data[2]
    length = data[3] | (data[4] << 8)
    if nss not in (1, 2) or length > 4095:
        return None
    if fmt == 0 and (mcs > 7 or nss != 1):
        return None
    if fmt == 1 and (mcs > 15 or mcs // 8 + 1 != nss):
        return None
    if fmt == 2 and mcs > 8:
        return None
    if length == 0:
        if fmt != 2:
            return None
        return TxRequest("ndp", fmt=Fmt(fmt), mcs=mcs, nss=nss)
    payload = data[5: 5 + length]
    if len(payload) != length:
        return None
    return TxRequest("data", fmt=Fmt(fmt), mcs=mcs, nss=nss, payload=payload)


def pack_phy_to_mac(fmt: int, payload: bytes, mcs: int) -> bytes:
    return bytes([fmt, len(payload) & 0xFF, len(payload) >> 8]) + payload + bytes([mcs])


def pack_chan_report(chan_2x64: np.ndarray) -> bytes:
    """(2, 64) complex channel -> type-20 report (1027 bytes)."""
    flat = np.asarray(chan_2x64, dtype=np.complex64).reshape(128)
    buf = np.empty(256, np.float32)
    buf[0::2] = flat.real
    buf[1::2] = flat.imag
    b = buf.tobytes()
    return bytes([F_NDP_CHAN, len(b) & 0xFF, len(b) >> 8]) + b


def parse_phy_to_mac(data: bytes):
    """-> (fmt, payload, mcs) or (20, chan (2,64) complex, None)."""
    if len(data) < 3:
        return None
    fmt = data[0]
    length = data[1] | (data[2] << 8)
    if fmt == F_NDP_CHAN:
        q = np.frombuffer(data[3: 3 + length], dtype=np.float32)
        chan = (q[0::2] + 1j * q[1::2]).reshape(2, 64)
        return (F_NDP_CHAN, chan, None)
    payload = data[3: 3 + length]
    mcs = data[3 + length]
    return (fmt, payload, mcs)


class PhyTxServer(threading.Thread):
    """Listens on :9528, synthesizes waveforms, hands them to a sink.

    ``sink(waveform (nss, n) complex64, request)`` is called per packet;
    default sink appends to an internal list (sample-file or SDR sinks are
    thin wrappers).  Holds the latest BFQ for MU requests like modulation2.
    """

    def __init__(self, sink=None, port: int = MAC_TO_PHY_PORT,
                 host: str = "127.0.0.1", device_tx: bool = False,
                 device="cuda"):
        super().__init__(daemon=True)
        from ..gold import tx as gtx
        self._gtx = gtx
        #: device_tx=True synthesizes on ``device`` through the batched
        #: models.tx engines (incl. the MU/beamformed tx_batch_mu path;
        #: "cuda" raises where there is no card); False keeps the numpy
        #: gold model
        self._eng = None
        if device_tx:
            from ..models.tx import TxEngine
            self._eng = TxEngine(device=device)
        self.sink = sink or (lambda w, req: self.waves.append(w))
        self.waves: list[np.ndarray] = []
        self.bfq = np.tile(np.eye(2, dtype=complex), (64, 1, 1))
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self._stop_evt = threading.Event()

    def stop(self):
        self._stop_evt.set()

    def handle(self, req: TxRequest):
        g = self._gtx
        if req.kind == "bfq":
            self.bfq = req.bfq
            return
        if req.kind == "ndp":
            cfg = PhyConfig(Fmt.VHT, 0, req.nss, 0, ampdu=True)
            self.sink(g.tx_waveform(cfg, b"", group_id=0, partial_aid=0), req)
            return
        if req.kind == "mu":
            users = tuple(
                PhyConfig(Fmt.VHT, req.mcs[u], req.nss[u], len(req.payloads[u]),
                          ampdu=True) for u in range(2))
            mu = MuConfig(users, group_id=req.group_id)
            if self._eng is not None:
                w = self._eng.tx_mu(mu, [[p] for p in req.payloads],
                                    self.bfq)[0]
            else:
                w = g.tx_waveform_mu(mu, list(req.payloads), self.bfq)
            self.sink(w, req)
            return
        fmt = req.fmt
        # GR wire behavior: VHT requests are always A-MPDUs, HT requests keep
        # the HT-SIG aggregation bit clear (lib/cloud80211phy.cc:2487-2524)
        cfg = PhyConfig(fmt, req.mcs, req.nss, len(req.payload),
                        ampdu=(fmt == Fmt.VHT))
        if self._eng is not None:
            kw = dict(group_id=0, partial_aid=0) if fmt == Fmt.VHT else {}
            self.sink(self._eng.tx(cfg, [req.payload], **kw)[0], req)
            return
        kw = dict(group_id=0, partial_aid=0) if fmt == Fmt.VHT else {}
        self.sink(g.tx_waveform(cfg, req.payload, **kw), req)

    def run(self):
        while not self._stop_evt.is_set():
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            req = parse_mac_to_phy(data)
            if req is not None:
                try:
                    self.handle(req)
                except Exception as e:  # malformed-but-parsable request
                    print(f"phy tx server: dropped request: {e}",
                          file=sys.stderr)
        self.sock.close()


class PhyRxReporter:
    """Sends decoded results to the MAC listener on :9527."""

    def __init__(self, port: int = PHY_TO_MAC_PORT, host: str = "127.0.0.1"):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def report(self, rx_result) -> None:
        """Publish an RxResult (from models.rx / gold.rx)."""
        if rx_result.is_ndp and rx_result.ndp_chan is not None:
            chan = np.asarray(rx_result.ndp_chan)[0, :2, :]  # rx ant 0, 2 sts
            self.sock.sendto(pack_chan_report(chan), self.addr)
            return
        if not rx_result.ok:
            return
        for mpdu in rx_result.mpdus:
            self.sock.sendto(
                pack_phy_to_mac(int(rx_result.fmt), mpdu, rx_result.mcs),
                self.addr)
