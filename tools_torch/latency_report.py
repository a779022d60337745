#!/usr/bin/env python3
"""Per-packet latency through the streaming daemons, and the fused
chain's latency per batch size.

    python3 tools_torch/latency_report.py [MCS,...] [N_PKTS] [B,...]
        [--device cuda] [--out results_torch/latency.json]

Defaults: VHT MCS0-8, 25 packets a point, batches 1, 256 and 4096; VHT
payloads of 30 B and 300 B. Counterpart of the reference's latency study
(its ``Measurement_Report.pdf``: per-packet block latency, and the TX ->
channel -> RX round trip without a radio).

* Daemon round trip: MAC UDP request -> ``PhyTxServer`` (waveform on the
  device) -> ``TxStreamer`` -> cf32 UDP -> native ``UdpIngest`` ->
  ``IqRing`` -> ``RxStreamer`` (64k-sample overlap-save blocks,
  ``RxEngine`` on the device) -> ``PhyRxReporter`` -> MAC UDP. One packet
  in flight; its block is flushed out of the ring with trailing silence;
  each MPDU carries a sequence tag so reports match requests. RTT is the
  host clock from the request sent to the report received; the first two
  packets of a point warm up and are not counted. Every socket binds port
  0.
* Fused chain: ``rx_chain_count`` on B packets (30 dB, 500 Hz CFO), five
  blocking calls after two untimed ones, host clock; the median and that
  median over B (the amortized per-packet cost).

Writes the JSON (with the kernels' launch counts and K1/K2's launch
shapes over both parts) to ``--out`` and a markdown table
(``LATENCY.md``) beside it; every number in both was taken on the device
named in them.
"""
from __future__ import annotations

import argparse
import json
import socket
import statistics
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools_torch import bench, timing  # noqa: E402

PAYLOADS = (30, 300)


def pctl(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


def run_daemon_rtt(mcs_list, n_pkts, dev, block_len=1 << 16, halo=16384):
    from gr_ieee80211_tpu_torch.gold import mac
    from gr_ieee80211_tpu_torch.models.rx import RxEngine
    from gr_ieee80211_tpu_torch.runtime import native as NAT
    from gr_ieee80211_tpu_torch.runtime.streaming import RxStreamer, TxStreamer
    from gr_ieee80211_tpu_torch.runtime.udp_phy import (
        PhyRxReporter, PhyTxServer, parse_phy_to_mac)

    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(3)]
    mac_rx, mac_tx, sil_sock = socks
    mac_rx.bind(("127.0.0.1", 0))
    mac_rx.settimeout(0.05)
    ring = NAT.IqRing(1 << 22)
    ing = NAT.UdpIngest(ring, port=0)
    streamer = RxStreamer(ring, RxEngine(nrx=1, device=dev),
                          block_len=block_len, halo=halo, poll_s=0.002,
                          reporter=PhyRxReporter(port=mac_rx.getsockname()[1]))
    tx_sink = TxStreamer(udp_addr=("127.0.0.1", ing.port), gap=1200, amp=0.2)
    phy_tx = PhyTxServer(sink=tx_sink, port=0, device_tx=True, device=dev)
    silence = np.zeros(4096, np.complex64).tobytes()

    def flush_block():
        # trailing silence so the burst's overlap-save block leaves the
        # ring (the no-more-samples condition of a file-input run)
        for _ in range(0, block_len + halo + 8192, 4096):
            sil_sock.sendto(silence, ("127.0.0.1", ing.port))

    results = {}
    streamer.start()
    phy_tx.start()
    try:
        for mcs in mcs_list:
            for plen in PAYLOADS:
                rtts, lost = [], 0
                for it in range(n_pkts + 2):   # the first 2 warm up
                    seq = (mcs << 20) | (plen << 8) | (it & 0xFF)
                    body = seq.to_bytes(4, "big") + bytes(plen - 4)
                    psdu = mac.ampdu_aggregate_vht([mac.qos_data_frame(
                        body, *bench.ADDR, 1)])
                    hdr = bytes([2, mcs, 1, len(psdu) & 0xFF, len(psdu) >> 8])
                    nb0 = tx_sink.n_bursts
                    tic = time.perf_counter()
                    mac_tx.sendto(hdr + psdu, ("127.0.0.1", phy_tx.port))
                    while tx_sink.n_bursts == nb0:     # burst fully emitted
                        time.sleep(0.0002)
                    flush_block()
                    deadline = time.time() + (600 if it < 2 else 15)
                    got = None
                    while time.time() < deadline and got is None:
                        if streamer.error is not None:
                            raise RuntimeError(
                                f"streamer failed: {streamer.error!r}")
                        try:
                            data, _ = mac_rx.recvfrom(65536)
                        except socket.timeout:
                            continue
                        parsed = parse_phy_to_mac(data)
                        if parsed is not None and len(parsed[1]) >= 30 \
                                and parsed[1][26:30] == body[:4]:
                            got = time.perf_counter()
                    if got is None:
                        lost += 1
                    elif it >= 2:
                        rtts.append((got - tic) * 1e3)
                r = {"n": len(rtts), "lost": lost}
                if rtts:
                    r.update(p50_ms=pctl(rtts, 50), p95_ms=pctl(rtts, 95),
                             mean_ms=statistics.mean(rtts))
                results[(mcs, plen)] = r
                bench.log(f"daemon RTT vht mcs{mcs} {plen}B: {r}")
    finally:
        streamer.stop()
        phy_tx.stop()
        streamer.join(timeout=60)
        phy_tx.join(timeout=60)
        ing.stop()
        ring.close()
        tx_sink.close()
        for s in socks:
            s.close()
    return results


def run_fused_latency(mcs_list, batches, dev):
    """Blocking ``rx_chain_count`` latency per batch size."""
    from gr_ieee80211_tpu_torch.gold import channel, mac, tx
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    rng = np.random.default_rng(7)
    out = {}
    for mcs in mcs_list:
        for plen in PAYLOADS:
            mpdu = mac.qos_data_frame(
                bytes(rng.integers(0, 256, plen, dtype=np.uint8)),
                *bench.ADDR, 1)
            am = mac.ampdu_aggregate_vht([mpdu])
            cfg = PhyConfig(Fmt.VHT, mcs, 1, len(am), ampdu=True)
            wave = channel.apply_cfo(
                tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0], 500.0
            ).astype(np.complex64)
            rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
            for B in batches:
                spacing = len(wave) + 240
                stream = np.zeros(B * spacing + 2048, np.complex64)
                for i in range(B):
                    stream[1024 + i * spacing:
                           1024 + i * spacing + len(wave)] = wave
                stream += (rng.normal(size=len(stream))
                           + 1j * rng.normal(size=len(stream))
                           ).astype(np.complex64) * (rms / 10 ** (30 / 20)
                                                     / np.sqrt(2))
                x = from_numpy_cf(stream[None], dev)

                def f():
                    return PRX.rx_chain_count(cfg, x, mpdu_len=len(mpdu),
                                              max_pkts=max(B, 16))
                n_ok = int(f()[0])                    # warm-up
                ts = []
                for _ in range(7):
                    tic = time.perf_counter()
                    int(f()[0])                       # blocking: latency
                    ts.append((time.perf_counter() - tic) * 1e3)
                ts = ts[2:]
                out[(mcs, plen, B)] = {"ok": n_ok, "of": B,
                                       "p50_ms": pctl(ts, 50),
                                       "per_pkt_us": pctl(ts, 50) * 1e3 / B}
                bench.log(f"fused vht mcs{mcs} {plen}B B={B}: "
                          f"{out[(mcs, plen, B)]}")
    return out


def markdown(device, mcs_list, daemon, fused) -> str:
    lines = [
        "# Latency / RTT report (PyTorch port)",
        "",
        f"Device: {device}. Written by `tools_torch/latency_report.py`.",
        "",
        "Daemon loop: MAC UDP request -> PhyTxServer (device TX) -> cf32 "
        "UDP -> native ingest -> RxStreamer (65536-sample blocks) -> MAC "
        "UDP report; one packet in flight, its block flushed with "
        "silence; host clock. Fused chain: blocking `rx_chain_count` "
        "calls, host clock, median of 5 after 2 untimed.",
        "",
        "## Daemon RTT, VHT, one packet in flight (ms)",
        "",
        "| MCS | 30 B p50 | 30 B p95 | 300 B p50 | 300 B p95 | lost |",
        "|---|---|---|---|---|---|",
    ]
    for m in mcs_list:
        a, b = daemon.get((m, 30), {}), daemon.get((m, 300), {})
        lines.append(
            f"| {m} | {a.get('p50_ms', '-')} | {a.get('p95_ms', '-')} "
            f"| {b.get('p50_ms', '-')} | {b.get('p95_ms', '-')} "
            f"| {a.get('lost', '-')} + {b.get('lost', '-')} |")
    lines += ["", "## Fused chain (known config)", "",
              "| MCS | payload | batch | ok | p50 ms/batch | us/packet |",
              "|---|---|---|---|---|---|"]
    for (m, p, b), v in fused.items():
        lines.append(f"| {m} | {p} B | {b} | {v['ok']} | {v['p50_ms']} "
                     f"| {v['per_pkt_us']} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mcs", nargs="?", default=",".join(map(str, range(9))))
    ap.add_argument("n_pkts", type=int, nargs="?", default=25)
    ap.add_argument("batches", nargs="?", default="1,256,4096")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = timing.require_device(a.device)
    mcs_list = [int(x) for x in a.mcs.split(",")]
    batches = tuple(int(x) for x in a.batches.split(","))

    (fused, daemon), moved = timing.with_counters(
        lambda: (run_fused_latency(mcs_list, batches, dev),
                 run_daemon_rtt(mcs_list, a.n_pkts, dev)), dev)
    kern = timing.kernel_launches(moved)
    device = timing.device_info(dev)
    out = timing.out_path("latency.json", a.out)
    timing.write_json(out, {
        "device": device,
        "daemon_rtt": {f"mcs{m}_{p}B": v for (m, p), v in daemon.items()},
        "fused_chain": {f"mcs{m}_{p}B_B{b}": v
                        for (m, p, b), v in fused.items()}, **kern})
    md = out.with_name("LATENCY.md")
    md.write_text(markdown(device, mcs_list, daemon, fused))
    print(json.dumps({"out": str(out), "markdown": str(md),
                      "lost": sum(v["lost"] for v in daemon.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
