#!/usr/bin/env python3
"""2x2 SU-MIMO and MU-STA receive throughput on the device.

    python3 tools_torch/bench_mu.py [B] [--device cuda] [--reps 40]
        [--out results_torch/bench_mu.json]

The MU/MIMO companion of ``tools_torch/bench.py``, on the streams of
``tools_tpu/bench_mu.py`` (``default_rng(3)``, B = 2048 by default, 240-
sample gaps, 32 dB):

* ``su2``: VHT MCS7 2 SS, a 530 B MPDU, through a fixed 2x2 channel with
  700 Hz CFO, two antennas, ``rx_chain_count(nrx=2)``;
* ``mu0``: a two-user VHT MU PPDU (user 0 MCS3, user 1 MCS2) zero-forcing
  precoded from two random 1x2 station channels, as station 0 hears it
  with 300 Hz CFO, ``rx_chain_count_mu(own=0)``.

Each is timed over ``--reps`` warmed calls (CUDA events around each call
on the card, median and quartiles). Prints one JSON line and writes it to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools_torch import bench, timing  # noqa: E402


def build_stream(burst, n_pkts, gap, rng, snr_db=32.0):
    """``n_pkts`` copies of the (nrx, n) ``burst`` from sample 1024, ``gap``
    samples apart, plus AWGN ``snr_db`` below the burst's RMS."""
    nrx, n = burst.shape
    spacing = n + gap
    stream = np.zeros((nrx, n_pkts * spacing + 2048), np.complex64)
    for i in range(n_pkts):
        stream[:, 1024 + i * spacing: 1024 + i * spacing + n] = burst
    rms = float(np.sqrt(np.mean(np.abs(burst) ** 2)))
    noise = (rng.normal(size=stream.shape) + 1j * rng.normal(size=stream.shape)
             ).astype(np.complex64) * (rms / 10 ** (snr_db / 20) / np.sqrt(2))
    return stream + noise


def run(name, fn, n_pkts, dev, reps, out):
    (n_ok, n_det), moved = timing.with_counters(
        lambda: tuple(int(v) for v in fn()), dev)
    t = timing.call_ms(fn, dev, reps)
    out[name] = {"n_ok": n_ok, "n_det": n_det, "ms_per_batch": t["median_ms"],
                 "q1_ms": t["q1_ms"], "q3_ms": t["q3_ms"],
                 "pkt_per_s": n_pkts / t["median_ms"] * 1e3,
                 **timing.kernel_launches(moved)}
    bench.log(f"{name}: ok {n_ok}/{n_pkts}, det {n_det}, "
              f"{t['median_ms']:.2f} ms/batch, "
              f"{out[name]['pkt_per_s']:,.0f} pkt/s")
    return out[name]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=2048)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = timing.require_device(a.device)
    from gr_ieee80211_tpu_torch.gold import channel, mac, sounding, tx
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
    from gr_ieee80211_tpu_torch.spec.params import Fmt, MuConfig, PhyConfig

    rng = np.random.default_rng(3)
    B = a.batch
    paths = {}

    # 2x2 SU-MIMO: VHT MCS7 2 SS, 500 B, 2 RX antennas
    payload = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, *bench.ADDR, 7)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 7, 2, len(am), ampdu=True)
    wave = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)
    h = np.array([[1.0, 0.25 + 0.1j], [0.2 - 0.15j, 0.9]], complex)
    burst = channel.apply_cfo(channel.mimo_channel(wave, h), 700.0
                              ).astype(np.complex64)
    x2 = from_numpy_cf(build_stream(np.atleast_2d(burst), B, 240, rng), dev)
    su2 = run("su2", lambda: PRX.rx_chain_count(cfg, x2, nrx=2,
                                                mpdu_len=len(mpdu),
                                                max_pkts=B),
              B, dev, a.reps, paths)
    del x2

    # MU-STA: 2-user VHT MU, user 0 MCS3, zero-forcing precoded
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
             / np.sqrt(2) for _ in range(2)]
    m0 = mac.qos_data_frame(b"user zero data " * 8, "02:00:00:00:00:10",
                            "02:00:00:00:00:01", "02:00:00:00:00:10", 5)
    m1 = mac.qos_data_frame(b"USER ONE DATA " * 6, "02:00:00:00:00:11",
                            "02:00:00:00:00:01", "02:00:00:00:00:11", 6)
    a0, a1 = mac.ampdu_aggregate_vht([m0]), mac.ampdu_aggregate_vht([m1])
    mu = MuConfig((PhyConfig(Fmt.VHT, 3, 1, len(a0), ampdu=True),
                   PhyConfig(Fmt.VHT, 2, 1, len(a1), ampdu=True)), group_id=2)
    h_rows = np.stack([np.repeat(hs[0][:, None], 56, axis=1) for hs in h_sta])
    muw = tx.tx_waveform_mu(mu, [a0, a1],
                            sounding.q_to_grid(sounding.zf_q(h_rows)))
    mburst = channel.apply_cfo(channel.mimo_channel(muw, h_sta[0])[0], 300.0
                               ).astype(np.complex64)
    xm = from_numpy_cf(build_stream(mburst[None], B, 240, rng), dev)
    u0 = mu.users[0]
    mcfg = PhyConfig(Fmt.VHT, u0.mcs, 1, u0.psdu_len, ampdu=True,
                     mu_nsym=mu.nsym)
    mu0 = run("mu0", lambda: PRX.rx_chain_count_mu(mcfg, xm, n_total=2,
                                                   own=0, nrx=1,
                                                   mpdu_len=len(m0),
                                                   max_pkts=B),
              B, dev, a.reps, paths)
    blob = {"su_2x2_vht_mcs7_500B_pkts_per_s": su2["pkt_per_s"],
            "su_2x2_ok": su2["n_ok"],
            "mu_sta_vht_mcs3_pkts_per_s": mu0["pkt_per_s"],
            "mu_sta_ok": mu0["n_ok"], "batch": B,
            "device": timing.device_info(dev), "reps": a.reps, **paths}
    timing.write_json(timing.out_path("bench_mu.json", a.out), blob)
    print(json.dumps(blob))
    return 0


if __name__ == "__main__":
    sys.exit(main())
