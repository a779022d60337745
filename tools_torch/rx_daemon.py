"""Streaming RX daemon of the PyTorch port: the rx.grc flowgraph equivalent.

IQ in from a cf32 UDP stream (native C++ ingest thread) or a .bin file
replayed at a given rate; decoded MPDUs / NDP channel reports out on the
reference MAC wire (UDP :9527).  The reference's macExampleGrRx.py works
unmodified as the listener.

  python tools_torch/rx_daemon.py --udp-iq 9000            # live cf32 in
  python tools_torch/rx_daemon.py --file capture.bin       # replay
  python tools_torch/rx_daemon.py --udp-iq 9000 9001       # 2-antenna rx2.grc
  python tools_torch/rx_daemon.py --file ant0.bin ant1.bin # 2-antenna replay
      [--block 524288] [--halo 16384] [--report-port 9527]
      [--mu-pos N] [--mu-gid G] [--stats-every 5] [--device cuda]

The port's ``RxEngine`` decodes each block on ``--device`` ("cuda" by
default, which needs a card; "cpu" runs the kernels' plain twins).

Every ``--stats-every`` seconds (and once at the end of ``--once``) it
prints the blocks and packets decoded, the per-(format, MCS) tallies,
the engine's counters since the start (``utils/trace``: host-device
synchronizations, bucket decodes and their rows, speculation hits and
misses; with ``--mu-pos``, the MU PPDUs of its group decoded, the MU
payload calls and the PPDUs rejected by their SIG-B / SERVICE checks) and
the ring's backlog, its high-water mark since the last line.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def engine_line(c: dict, backlog: int, mu: bool = False) -> str:
    """The stats line's engine part from a ``trace.snapshot()`` and the
    streamer's backlog; with ``mu`` (an MU station) also its MU PPDUs
    decoded, its MU payload calls and the PPDUs whose SIG-B or SERVICE
    check failed."""
    def g(k):
        return int(c.get(k, 0))
    line = (f"syncs {g('sync.total')}  buckets {g('rx.bucket.calls')} "
            f"rows {g('rx.bucket.rows')}  spec hits {g('rx.spec.hits')} "
            f"misses {g('rx.spec.misses')}  backlog {backlog}")
    if mu:
        line += (f"  mu rows {g('rx.mu.rows')}  mu calls {g('rx.mu.calls')}"
                 f"  mu rejected {g('rx.mu.sigb_rejected')}/"
                 f"{g('rx.mu.service_rejected')}")
    return line


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--udp-iq", type=int, nargs="+", default=None,
                    help="UDP port(s) receiving interleaved-cf32 datagrams, "
                         "one per RX antenna")
    ap.add_argument("--file", nargs="+", default=None,
                    help="cf32 .bin file(s) to replay, one per RX antenna")
    ap.add_argument("--block", type=int, default=1 << 19)
    ap.add_argument("--halo", type=int, default=16384)
    ap.add_argument("--report-port", type=int, default=9527)
    ap.add_argument("--mu-pos", type=int, default=None)
    ap.add_argument("--mu-gid", type=int, default=None)
    ap.add_argument("--stats-every", type=float, default=5.0)
    ap.add_argument("--once", action="store_true",
                    help="with --file: drain and exit")
    ap.add_argument("--f32-ingest", action="store_true",
                    help="upload blocks as f32 pairs instead of bf16 "
                         "(bf16 halves the host->device bytes; ~49 dB "
                         "SQNR, below channel noise at any decodable SNR)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine decodes on")
    args = ap.parse_args()
    if (args.udp_iq is None) == (args.file is None):
        ap.error("exactly one of --udp-iq / --file required")

    from gr_ieee80211_tpu_torch.runtime import native as NAT
    from gr_ieee80211_tpu_torch.runtime.udp_phy import PhyRxReporter
    from gr_ieee80211_tpu_torch.runtime.streaming import RxStreamer
    from gr_ieee80211_tpu_torch.models.rx import RxEngine
    from gr_ieee80211_tpu_torch.utils import trace

    nrx = len(args.udp_iq or args.file)
    rings = [NAT.IqRing(1 << 23) for _ in range(nrx)]
    ings = []
    if args.udp_iq is not None:
        ings = [NAT.UdpIngest(r, port=p) for r, p in zip(rings, args.udp_iq)]
        print("ingesting cf32 on udp:"
              + ",".join(str(i.port) for i in ings), file=sys.stderr)
    eng = RxEngine(nrx=nrx, mu_pos=args.mu_pos, mu_gid=args.mu_gid,
                   ingest="f32" if args.f32_ingest else "bf16",
                   device=args.device)
    mu = args.mu_pos is not None
    streamer = RxStreamer(rings, eng, block_len=args.block, halo=args.halo,
                          reporter=PhyRxReporter(port=args.report_port))
    streamer.start()
    print(f"reporting decoded packets to udp:{args.report_port}",
          file=sys.stderr)

    try:
        if args.file is not None:
            streams = [np.fromfile(f, np.complex64) for f in args.file]
            n = min(len(d) for d in streams)
            print(f"replaying {n/1e6:.1f} M samples x {nrx}", file=sys.stderr)
            offs = [0] * nrx
            while min(offs) < n:
                for k in range(nrx):   # per-ring offsets: no cross-ring skew
                    if offs[k] < n:
                        offs[k] += rings[k].write(
                            streams[k][offs[k]: offs[k] + (1 << 16)]) or 0
                time.sleep(0.001)
            streamer.stop(drain=True)
            streamer.join(timeout=600)
            if streamer.error is not None or streamer.is_alive():
                print(f"streamer failed: {streamer.error!r}", file=sys.stderr)
                return 1
            print(f"done: {streamer.n_blocks} blocks, "
                  f"{streamer.n_ok}/{streamer.n_packets} packets ok",
                  file=sys.stderr)
            print(engine_line(trace.snapshot(), streamer.fill_max, mu),
                  file=sys.stderr)
            return 0
        while True:
            time.sleep(args.stats_every)
            if streamer.error is not None:
                print(f"streamer failed: {streamer.error!r}", file=sys.stderr)
                return 1
            s = [i.stats for i in ings]
            # per-(fmt, mcs) tallies with mean SNR/RSSI: the reference
            # decode block's debug print (lib/decode_impl.cc:393-411)
            tallies = "  ".join(
                f"{k[0].name if k[0] is not None else '?'}{k[1]}:"
                f"{v['ok']}/{v['total']}"
                f"@{v['snr_db_mean']:.0f}dB"
                for k, v in sorted(streamer.counter_summary().items(),
                                   key=str))
            backlog, streamer.fill_max = streamer.fill_max, 0
            print(f"blocks {streamer.n_blocks}  pkts ok "
                  f"{streamer.n_ok}/{streamer.n_packets}  ingest {s}  "
                  f"[{tallies}]  "
                  f"{engine_line(trace.snapshot(), backlog, mu)}",
                  file=sys.stderr)
    except KeyboardInterrupt:
        return 0
    finally:
        streamer.stop()
        for i in ings:
            i.stop()


if __name__ == "__main__":
    sys.exit(main())
