"""The port's streaming runtime on the CPU: MAC UDP -> ``PhyTxServer`` ->
``TxStreamer`` -> cf32 UDP -> native ingest -> ring -> ``RxStreamer`` over
the port's ``RxEngine(device="cpu")`` -> ``PhyRxReporter`` UDP -> MAC.
The tests of ``tests/test_streaming.py`` and ``test_streaming2x2.py`` on
the port's modules: the rx.grc/tx.grc loopback at one and two antennas,
ownership of a block-edge packet by its trigger, and timed TX placement.
Every socket binds port 0.
"""
import socket
import time

import numpy as np
import pytest
import torch

from gr_ieee80211_tpu_torch.gold import channel, mac, tx
from gr_ieee80211_tpu_torch.models.rx import RxEngine
from gr_ieee80211_tpu_torch.runtime import native as NAT
from gr_ieee80211_tpu_torch.runtime.streaming import RxStreamer, TxStreamer
from gr_ieee80211_tpu_torch.runtime.udp_phy import (
    PhyRxReporter, PhyTxServer, parse_phy_to_mac)
from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
from gr_ieee80211_tpu_torch.utils.io import read_cf32

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(not NAT.available(),
                                reason="native runtime unavailable")

ADDR = ("f4:69:d5:80:0f:a0", "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0")


def _listener():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.settimeout(5.0)
    return s


def _collect(mac_rx, streamer, want, timeout=300):
    """{(fmt, mcs): payload} of the reports until ``want`` keys arrived."""
    got = {}
    deadline = time.time() + timeout
    while len(got) < want and time.time() < deadline:
        assert streamer.error is None, streamer.error
        try:
            data, _ = mac_rx.recvfrom(65536)
        except socket.timeout:
            continue
        fmt, pl, mcs = parse_phy_to_mac(data)
        got[(fmt, mcs)] = pl
    return got


def test_udp_ingest_into_ring():
    ring = NAT.IqRing(1 << 16)
    ing = NAT.UdpIngest(ring, port=0)
    tx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    data = (np.arange(1024) + 1j * np.arange(1024)).astype(np.complex64)
    tx_sock.sendto(data.tobytes(), ("127.0.0.1", ing.port))
    tx_sock.close()
    deadline = time.time() + 3
    while ring.fill < 1024 and time.time() < deadline:
        time.sleep(0.01)
    assert ring.fill == 1024
    blk = ring.read_block(1000, 24)
    assert blk is not None and np.array_equal(blk, data)
    assert ing.stats["datagrams"] == 1 and ing.stats["dropped"] == 0
    ing.stop()
    ring.close()


def test_full_stream_loopback_mac_to_mac():
    mac_rx = _listener()
    ring = NAT.IqRing(1 << 21)
    ing = NAT.UdpIngest(ring, port=0)
    streamer = RxStreamer(ring, RxEngine(nrx=1, device="cpu"),
                          block_len=1 << 16, halo=16384,
                          reporter=PhyRxReporter(
                              port=mac_rx.getsockname()[1]))
    streamer.start()
    tx_sink = TxStreamer(udp_addr=("127.0.0.1", ing.port), gap=1500,
                         amp=0.2)
    phy_tx = PhyTxServer(sink=tx_sink, port=0)
    phy_tx.start()

    # the reference MAC side: 5-byte header + PSDU over UDP
    payload = mac.llc_ip_udp(b"streaming loopback!", "192.168.13.1",
                             "192.168.13.2", 9000, 9001)
    mpdus = []
    mac_tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for fmt, mcs in ((0, 3), (2, 5)):
        mpdu = mac.qos_data_frame(payload, *ADDR, 11 + fmt)
        psdu = mac.ampdu_aggregate_vht([mpdu]) if fmt == 2 else mpdu
        hdr = bytes([fmt, mcs, 1, len(psdu) & 0xFF, len(psdu) >> 8])
        mac_tx.sendto(hdr + psdu, ("127.0.0.1", phy_tx.port))
        mpdus.append((fmt, mcs, mpdu))
    mac_tx.close()
    try:
        # wait for both bursts to land in the ring, then pad with silence
        # so a full overlap-save block (block_len + halo) flushes through
        deadline = time.time() + 10
        while ing.stats["samples"] < 5000 and time.time() < deadline:
            time.sleep(0.02)
        ring.write(np.zeros((1 << 16) + 16384 + 64, np.complex64))
        got = _collect(mac_rx, streamer, 2)
    finally:
        phy_tx.stop()
        streamer.stop()
        ing.stop()
        phy_tx.join(timeout=3)
        streamer.join(timeout=60)
        mac_rx.close()
        tx_sink.close()
    assert streamer.error is None, streamer.error
    assert ing.stats["dropped"] == 0
    for fmt, mcs, mpdu in mpdus:
        assert got.get((fmt, mcs)) == mpdu, (fmt, mcs, streamer.n_packets)
    ring.close()


def test_full_2x2_stream_loopback_mac_to_mac():
    """tx2.grc/rx2.grc: both antenna streams framed and ingested; a 1-SS
    burst zero-fills antenna 1 so both ingests count the same samples."""
    mac_rx = _listener()
    rings = [NAT.IqRing(1 << 21), NAT.IqRing(1 << 21)]
    ings = [NAT.UdpIngest(r, port=0) for r in rings]
    streamer = RxStreamer(rings, RxEngine(nrx=2, device="cpu"),
                          block_len=1 << 16, halo=16384,
                          reporter=PhyRxReporter(
                              port=mac_rx.getsockname()[1]))
    streamer.start()
    tx_sink = TxStreamer(udp_addr=[("127.0.0.1", i.port) for i in ings],
                         gap=1500, amp=0.2)
    phy_tx = PhyTxServer(sink=tx_sink, port=0)
    phy_tx.start()

    payload = mac.llc_ip_udp(b"two antennas!", "192.168.13.1",
                             "192.168.13.2", 9000, 9001)
    mac_tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sent = []
    for mcs, nss, seq in ((4, 2, 11), (5, 1, 12)):
        mpdu = mac.qos_data_frame(payload, *ADDR, seq)
        psdu = mac.ampdu_aggregate_vht([mpdu])
        hdr = bytes([2, mcs, nss, len(psdu) & 0xFF, len(psdu) >> 8])
        mac_tx.sendto(hdr + psdu, ("127.0.0.1", phy_tx.port))
        sent.append((2, mcs, mpdu))
    mac_tx.close()
    try:
        deadline = time.time() + 10
        while (min(i.stats["samples"] for i in ings) < 5000
               and time.time() < deadline):
            time.sleep(0.02)
        deadline = time.time() + 10
        while (len({i.stats["samples"] for i in ings}) > 1
               and time.time() < deadline):
            time.sleep(0.02)
        s0, s1 = (i.stats["samples"] for i in ings)
        assert s0 == s1, (s0, s1)
        for r in rings:
            r.write(np.zeros((1 << 16) + 16384 + 64, np.complex64))
        got = _collect(mac_rx, streamer, 2)
    finally:
        phy_tx.stop()
        streamer.stop()
        for i in ings:
            i.stop()
        phy_tx.join(timeout=3)
        streamer.join(timeout=60)
        mac_rx.close()
        tx_sink.close()
    assert streamer.error is None, streamer.error
    assert all(i.stats["dropped"] == 0 for i in ings)
    for fmt, mcs, mpdu in sent:
        assert got.get((fmt, mcs)) == mpdu, (fmt, mcs, streamer.n_packets,
                                             streamer.counters)
    for r in rings:
        r.close()


def test_block_boundary_packet_owned_by_trigger():
    """A packet triggering just before the block edge (LTF past it) is
    decoded exactly once: ownership follows the trigger, not the LTF."""
    rng = np.random.default_rng(3)
    mpdu = mac.qos_data_frame(b"edge case " * 6, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 9)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 4, 1, len(am), ampdu=True)
    wave = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    block = 8192
    stream = np.zeros(3 * block, np.complex64)
    # the trigger fires ~40 samples before the waveform start; the start
    # 50 samples before the boundary puts trig < block <= ltf_idx
    stream[block - 50: block - 50 + len(wave)] = wave
    stream[300: 300 + len(wave)] = wave          # control packet, block 0
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.awgn(stream[None], rms / 10 ** (32 / 20), rng)[0]

    ring = NAT.IqRing(1 << 16)
    got = []
    streamer = RxStreamer(ring, RxEngine(nrx=1, device="cpu"),
                          block_len=block, halo=4096, on_result=got.append)
    streamer.start()
    ring.write(stream)
    streamer.stop(drain=True, timeout=300)
    streamer.join(timeout=300)
    assert not streamer.is_alive()
    assert streamer.error is None, streamer.error
    ok = [r for r in got if r.ok and r.mpdus and r.mpdus[0] == mpdu]
    assert len(ok) == 2, [(r.trig, r.start, r.ok) for r in got]
    edge = [r for r in ok if r.trig > block - 200]
    assert len(edge) == 1 and edge[0].trig < block <= edge[0].start
    assert streamer.n_packets == streamer.n_ok == 2
    assert streamer.counter_summary()[(Fmt.VHT, 4)]["ok"] == 2
    ring.close()


def test_tx_streamer_timed_burst_placement(tmp_path):
    """pad2's tx_time contract: timed bursts land at sample-accurate
    scheduled positions (stream position + lead) with explicit
    inter-burst silence."""
    rng = np.random.default_rng(5)
    p = str(tmp_path / "timed.bin")
    sink = TxStreamer(path=p, timed=True, lead=1200)
    w0 = (rng.normal(size=300) + 1j * rng.normal(size=300)
          ).astype(np.complex64)
    w1 = (rng.normal(size=500) + 1j * rng.normal(size=500)
          ).astype(np.complex64)
    sink(w0)
    sink(w1)
    sink.close()
    out = read_cf32(p)
    s0, s1 = sink.burst_starts
    assert s0 == 1200 and s1 == 1200 + 300 + 1200
    assert np.array_equal(out[s0: s0 + 300], w0)
    assert np.array_equal(out[s1: s1 + 500], w1)
    assert not out[:s0].any() and not out[s0 + 300: s1].any()
