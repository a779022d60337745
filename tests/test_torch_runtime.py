"""The port's UDP MAC<->PHY runtime: the tests of ``tests/test_runtime.py``
on ``gr_ieee80211_tpu_torch.runtime.udp_phy`` (device TX on the CPU
within 2e-5 of the gold model), and its four wire functions equal to the
JAX package's on the same seeded datagrams, malformed ones included."""
import socket
import time

import numpy as np
import pytest
import torch

from gr_ieee80211_tpu.runtime import udp_phy as JU
from gr_ieee80211_tpu_torch.gold import channel, mac, rx as grx
from gr_ieee80211_tpu_torch.runtime import udp_phy as U

torch.set_num_threads(2)


def _send(port, data):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.sendto(data, ("127.0.0.1", port))
    s.close()


def _wait(cond, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _mu_frames(tag: bytes):
    m0 = mac.qos_data_frame(tag + b" user0 " * 4, "02:00:00:00:00:10",
                            "02:00:00:00:00:01", "02:00:00:00:00:10", 5)
    m1 = mac.qos_data_frame(tag + b" user1 " * 3, "02:00:00:00:00:11",
                            "02:00:00:00:00:01", "02:00:00:00:00:11", 6)
    a0, a1 = mac.ampdu_aggregate_vht([m0]), mac.ampdu_aggregate_vht([m1])
    hdr = bytes([3, 2, 1, len(a0) & 0xFF, len(a0) >> 8,
                 1, 1, len(a1) & 0xFF, len(a1) >> 8, 2])
    return (m0, m1), (a0, a1), hdr


def _bfq_blob(q):
    buf = np.empty((64, 2, 2, 2), np.float32)
    buf[..., 0], buf[..., 1] = q.real, q.imag
    return bytes([U.F_BFQ]) + buf.tobytes()


def test_udp_tx_data_and_rx_report_loopback():
    srv = U.PhyTxServer(port=0)
    srv.start()
    try:
        mpdu = mac.qos_data_frame(b"runtime loopback " * 6,
                                  "f4:69:d5:80:0f:a0", "00:c0:ca:b1:5b:e1",
                                  "f4:69:d5:80:0f:a0", 3)
        am = mac.ampdu_aggregate_vht([mpdu])
        # 5-byte header datagram, the reference's genPktGrData format
        _send(srv.port, bytes([2, 4, 1, len(am) & 0xFF, len(am) >> 8]) + am)
        assert _wait(lambda: len(srv.waves) == 1)
        stream = channel.frame_stream(srv.waves[0], 1.0, 200.0, gap=1200)
        pkts = grx.receive(stream)
        assert pkts and pkts[0].ok and pkts[0].mpdus[0] == mpdu

        lsock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        lsock.bind(("127.0.0.1", 0))
        lsock.settimeout(5.0)
        rep = U.PhyRxReporter(port=lsock.getsockname()[1])
        rep.report(pkts[0])
        data, _ = lsock.recvfrom(65536)
        fmt, payload, mcs = U.parse_phy_to_mac(data)
        assert fmt == 2 and payload == mpdu and mcs == 4
        lsock.close()
    finally:
        srv.stop()
        srv.join(timeout=3)


def test_udp_ndp_and_bfq_and_mu():
    srv = U.PhyTxServer(port=0)
    srv.start()
    try:
        _send(srv.port, b"\x02\x00\x02\x00\x00")    # genPktGrNdp bytes
        assert _wait(lambda: len(srv.waves) == 1)
        assert srv.waves[0].shape[0] == 2
        _send(srv.port, _bfq_blob(np.tile(np.eye(2, dtype=np.complex64),
                                          (64, 1, 1))))
        ms, ams, hdr = _mu_frames(b"mu")
        _send(srv.port, hdr + ams[0] + ams[1])
        assert _wait(lambda: len(srv.waves) == 2)
        wave = srv.waves[1]
        assert wave.shape[0] == 2
        # identity Q + identity channel: each user decodes its own stream
        for u, m in enumerate(ms):
            stream = channel.frame_stream(wave[u: u + 1], 1.0, 100.0,
                                          gap=1200)
            pkts = grx.receive(stream, mu_pos=u)
            assert pkts and pkts[0].ok and pkts[0].mpdus[0] == m
    finally:
        srv.stop()
        srv.join(timeout=3)


def test_udp_server_device_tx_matches_gold():
    """device_tx=True synthesizes the same waveforms over the wire (SU data
    + BFQ'd MU) as the gold server, within 2e-5."""
    gold_srv = U.PhyTxServer(port=0)
    dev_srv = U.PhyTxServer(port=0, device_tx=True, device="cpu")
    gold_srv.start(), dev_srv.start()
    try:
        rng = np.random.default_rng(7)
        q = (rng.normal(size=(64, 2, 2)) + 1j * rng.normal(size=(64, 2, 2))
             ).astype(np.complex64) / np.sqrt(2)
        _, (a0, a1), mu_hdr = _mu_frames(b"dev tx")
        su_hdr = bytes([2, 4, 1, len(a0) & 0xFF, len(a0) >> 8])
        for srv in (gold_srv, dev_srv):
            _send(srv.port, _bfq_blob(q))
            _send(srv.port, su_hdr + a0)
            _send(srv.port, mu_hdr + a0 + a1)
        assert _wait(lambda: len(gold_srv.waves) == 2
                     and len(dev_srv.waves) == 2, timeout=60)
        for g, d in zip(gold_srv.waves, dev_srv.waves):
            g, d = np.atleast_2d(g), np.atleast_2d(d)
            assert g.shape == d.shape and np.abs(g - d).max() < 2e-5
    finally:
        gold_srv.stop(), dev_srv.stop()
        gold_srv.join(timeout=3), dev_srv.join(timeout=3)


def test_device_tx_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        U.PhyTxServer(port=0, device_tx=True)


def test_chan_report_roundtrip():
    rng = np.random.default_rng(1)
    chan = (rng.normal(size=(2, 64)) + 1j * rng.normal(size=(2, 64))
            ).astype(np.complex64)
    blob = U.pack_chan_report(chan)
    assert len(blob) == 1027
    fmt, parsed, _ = U.parse_phy_to_mac(blob)
    assert fmt == 20
    assert np.allclose(parsed, chan)


def _mac_to_phy_datagrams(rng):
    """Seeded MAC->PHY datagrams: valid data for every format and MCS, an
    NDP, MU and BFQ requests, and malformed ones (empty, short, nss 3,
    length > 4095, HT mcs // 8 + 1 != nss, L nss 2, VHT mcs 9, truncated
    payloads, non-VHT NDPs, unknown formats)."""
    out = []
    for fmt, mcs_max in ((0, 7), (1, 15), (2, 8)):
        for mcs in range(mcs_max + 1):
            nss = mcs // 8 + 1 if fmt == 1 else int(rng.integers(1, 3))
            n = int(rng.integers(1, 300))
            out.append(bytes([fmt, mcs, nss, n & 0xFF, n >> 8])
                       + rng.bytes(n))
    n = 200
    out += [b"", b"\x02", b"\x02\x04\x01\x10", b"\x02\x00\x02\x00\x00",
            b"\x00\x00\x01\x00\x00", b"\x01\x00\x01\x00\x00",
            bytes([2, 4, 3, n, 0]) + rng.bytes(n),
            bytes([2, 4, 1, 0xFF, 0x0F]) + rng.bytes(4095),
            bytes([2, 4, 1, 0x00, 0x10]) + rng.bytes(4096),
            bytes([1, 9, 1, n, 0]) + rng.bytes(n),
            bytes([1, 3, 2, n, 0]) + rng.bytes(n),
            bytes([0, 3, 2, n, 0]) + rng.bytes(n),
            bytes([0, 8, 1, n, 0]) + rng.bytes(n),
            bytes([2, 9, 1, n, 0]) + rng.bytes(n),
            bytes([2, 4, 1, n, 0]) + rng.bytes(n - 1),
            bytes([5, 4, 1, n, 0]) + rng.bytes(n),
            bytes([3, 2, 1, 40, 0, 1, 1, 30, 0, 2]) + rng.bytes(70),
            bytes([3, 2, 1, 40, 0, 1, 1, 30, 0, 2]) + rng.bytes(69),
            bytes([3, 2, 1, 40, 0, 1]),
            bytes([10]) + rng.normal(size=512).astype(np.float32).tobytes(),
            bytes([10]) + rng.normal(size=512).astype(np.float32).tobytes()[1:]]
    return out


def _req_fields(r):
    if r is None:
        return None
    return {k: (v.tobytes() if isinstance(v, np.ndarray) else
                int(v) if k == "fmt" else v) for k, v in vars(r).items()}


def test_wire_functions_equal_the_reference_package():
    """The four wire functions of both packages on the same seeded
    datagrams: equal requests (kind, fields, bytes, BFQ matrices bit for
    bit), equal packed reports, equal parses."""
    rng = np.random.default_rng(11)
    for d in _mac_to_phy_datagrams(rng):
        got, ref = U.parse_mac_to_phy(d), JU.parse_mac_to_phy(d)
        assert _req_fields(got) == _req_fields(ref), d[:12]
    for fmt in (0, 1, 2):
        for n in (0, 1, 255, 256, 4095):
            pl, mcs = rng.bytes(n), int(rng.integers(0, 16))
            blob = U.pack_phy_to_mac(fmt, pl, mcs)
            assert blob == JU.pack_phy_to_mac(fmt, pl, mcs)
            assert U.parse_phy_to_mac(blob) == JU.parse_phy_to_mac(blob) \
                == (fmt, pl, mcs)
    chan = (rng.normal(size=(2, 64)) + 1j * rng.normal(size=(2, 64)))
    blob = U.pack_chan_report(chan)
    assert blob == JU.pack_chan_report(chan)
    (f0, c0, m0), (f1, c1, m1) = (U.parse_phy_to_mac(blob),
                                  JU.parse_phy_to_mac(blob))
    assert (f0, m0) == (f1, m1) == (20, None)
    assert c0.dtype == c1.dtype and np.array_equal(c0, c1)
    for d in (b"", b"\x00\x01"):
        assert U.parse_phy_to_mac(d) is JU.parse_phy_to_mac(d) is None
    assert (U.PHY_TO_MAC_PORT, U.MAC_TO_PHY_PORT, U.F_MU, U.F_BFQ,
            U.F_NDP_CHAN) == (JU.PHY_TO_MAC_PORT, JU.MAC_TO_PHY_PORT,
                              JU.F_MU, JU.F_BFQ, JU.F_NDP_CHAN)
