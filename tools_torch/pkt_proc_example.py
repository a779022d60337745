"""Offline RX of a recorded cf32 file (pktProcExample.py equivalent).

Usage: python tools_torch/pkt_proc_example.py file0.bin [file1.bin]
           [--engine [--device cuda|cpu]]

Without ``--engine`` the port's numpy gold receiver decodes the file;
with it, the port's batched ``RxEngine`` on ``--device`` ("cuda" by
default, which needs a card).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
from gr_ieee80211_tpu_torch.utils.io import read_cf32


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="+", help="cf32 .bin file(s), one per "
                                             "RX antenna")
    ap.add_argument("--engine", action="store_true",
                    help="decode with the batched RxEngine")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine")
    args = ap.parse_args(argv)
    streams = np.stack([read_cf32(p) for p in args.files])
    if args.engine:
        from gr_ieee80211_tpu_torch.models.rx import RxEngine
        results = RxEngine(nrx=streams.shape[0],
                           device=args.device).process(streams)
    else:
        from gr_ieee80211_tpu_torch.gold import rx
        results = rx.receive(streams)
    n_ok = 0
    for r in results:
        if r.is_ndp:
            print(f"@{r.start}: NDP sounding, chan shape "
                  f"{None if r.ndp_chan is None else r.ndp_chan.shape}")
            continue
        status = "ok" if r.ok else "FCS FAIL"
        print(f"@{r.start}: fmt={getattr(r.fmt, 'name', r.fmt)} mcs={r.mcs} "
              f"nss={r.nss} cfo={r.cfo_hz:.0f}Hz {status} "
              f"mpdus={[len(m) for m in r.mpdus]}")
        n_ok += r.ok
    print(f"{n_ok}/{len(results)} packets decoded")


if __name__ == "__main__":
    main()
