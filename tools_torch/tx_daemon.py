"""Streaming TX daemon of the PyTorch port: the tx.grc flowgraph equivalent.

Listens for the reference 5/10-byte-header MAC->PHY datagrams on :9528
(macExampleGrTx.py / cmu scripts work unmodified), synthesizes the burst,
and frames it into a continuous cf32 sample stream written to a file and/or
sent as UDP datagrams (pairs with rx_daemon --udp-iq for loopback).

  python tools_torch/tx_daemon.py --out tx_stream.bin
  python tools_torch/tx_daemon.py --udp-out 9000 [--port 9528] [--amp 0.2]
  python tools_torch/tx_daemon.py --udp-out 9000 9001      # 2-antenna tx2.grc
      [--device cuda] [--gold-tx]

Bursts are synthesized by the port's ``TxEngine`` on ``--device`` ("cuda"
by default, which needs a card) or, with ``--gold-tx``, its numpy gold
model.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", nargs="+", default=None,
                    help="append cf32 stream file(s), one per antenna")
    ap.add_argument("--udp-out", type=int, nargs="+", default=None,
                    help="send cf32 datagrams to 127.0.0.1:<port>(s), "
                         "one per antenna")
    ap.add_argument("--port", type=int, default=9528)
    ap.add_argument("--gap", type=int, default=1200)
    ap.add_argument("--amp", type=float, default=0.2)
    ap.add_argument("--gold-tx", action="store_true",
                    help="synthesize with the numpy gold model instead "
                         "of the device engines (tx_batch / tx_batch_mu)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the TX engines")
    args = ap.parse_args()
    if args.out is None and args.udp_out is None:
        ap.error("need --out and/or --udp-out")

    from gr_ieee80211_tpu_torch.runtime.udp_phy import PhyTxServer
    from gr_ieee80211_tpu_torch.runtime.streaming import TxStreamer

    sink = TxStreamer(path=args.out,
                      udp_addr=[("127.0.0.1", p) for p in args.udp_out]
                      if args.udp_out else None,
                      gap=args.gap, amp=args.amp)
    srv = PhyTxServer(sink=sink, port=args.port,
                      device_tx=not args.gold_tx, device=args.device)
    srv.start()
    print(f"MAC->PHY requests on udp:{srv.port}; "
          f"{sink.n_streams} stream(s) -> {args.out or ''} "
          f"{('udp:%s' % args.udp_out) if args.udp_out else ''}",
          file=sys.stderr)
    try:
        while True:
            time.sleep(5)
            print(f"bursts: {sink.n_bursts}", file=sys.stderr)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
        sink.close()


if __name__ == "__main__":
    main()
