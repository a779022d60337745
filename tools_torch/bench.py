#!/usr/bin/env python3
"""Headline benchmark of the port: full-chain RX throughput, VHT MCS7.

    python3 tools_torch/bench.py [--device cuda] [--batch 4096] [--reps 40]
        [--out results_torch/bench_envelope.json]

The stream is ``bench.py``'s byte for byte (``default_rng(1)``: the 500 B
payload, then the 32 dB noise, then the 18 dB noise): B copies of one VHT
MCS7 1 SS A-MPDU (a 530 B MPDU) with 900 Hz CFO and 240-sample gaps.
``rx_chain_count`` (detect -> dedup -> sync -> demod -> syndrome-gated
decode -> FCS count) runs on it at 32 dB (the algebraic fast path) and at
18 dB (the floor: the dd pass and the full Viterbi, K1 + K2), each timed
over ``--reps`` warmed calls (CUDA events around each call on the card;
median and quartiles).

The reference ceiling (``bench.py``'s docstring): the reference decoder
alone costs at best 93 CPU ticks per LLR item at 4.9 GHz, so a packet of
nsym x 312 LLR items caps it at 4.9e9 / (nsym * 312 * 93) packets/s.

Prints ONE JSON line (``bench.py``'s keys and ``device``) to stdout and
writes the envelope (both operating points, counts, decode tiers, kernel
launches) to ``--out``; diagnostics go to stderr.
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

from tools_torch import timing  # noqa: E402

SNR_HI, SNR_LO = 32.0, 18.0
GAP = 240
CFO_HZ = 900.0
ADDR = ("f4:69:d5:80:0f:a0", "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_packet(rng, n_payload=500, mcs=7):
    """(cfg, mpdu, A-MPDU, waveform) of ``bench.py``: one
    ``n_payload``-byte payload drawn from ``rng`` in a QoS data MPDU, as a
    VHT 1 SS A-MPDU."""
    from gr_ieee80211_tpu_torch.gold import mac, tx
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    payload = bytes(rng.integers(0, 256, n_payload, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, *ADDR, 7)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, mcs, 1, len(am), ampdu=True)
    return cfg, mpdu, am, tx.tx_waveform(cfg, am, group_id=0,
                                         partial_aid=0)[0]


def lay(wave, n_pkts):
    """``n_pkts`` copies of ``wave`` with CFO_HZ, the first at sample
    1024, GAP samples between packets, 2048 samples of room at the end."""
    from gr_ieee80211_tpu_torch.gold import channel
    spacing = len(wave) + GAP
    base = np.zeros(n_pkts * spacing + 2048, np.complex64)
    w = channel.apply_cfo(wave, CFO_HZ).astype(np.complex64)
    for i in range(n_pkts):
        base[1024 + i * spacing: 1024 + i * spacing + len(wave)] = w
    return base


def noisy(base, rms, snr_db, rng):
    """``base`` plus complex AWGN ``snr_db`` below ``rms``, drawn as
    ``bench.py`` draws it (real parts, then imaginary parts) and rounded
    to complex64 as its in-place sum is."""
    n = len(base)
    noise = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64) * (rms / 10 ** (snr_db / 20) / np.sqrt(2))
    return (base + noise).astype(np.complex64)


def bench_streams(n_pkts=4096):
    """(cfg, mpdu, A-MPDU, waveform, {32.0: stream, 18.0: stream}):
    ``bench.py``'s streams."""
    rng = np.random.default_rng(1)
    cfg, mpdu, am, wave = bench_packet(rng)
    base = lay(wave, n_pkts)
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    return cfg, mpdu, am, wave, {snr: noisy(base, rms, snr, rng)
                                 for snr in (SNR_HI, SNR_LO)}


def ref_ceiling(cfg, llr_per_sym=312) -> float:
    """The reference decoder's best case in packets/s (93 ticks an LLR
    item at 4.9 GHz)."""
    return 4.9e9 / (cfg.nsym * llr_per_sym * 93)


def run_point(PRX, cfg, mpdu_len, x, n_pkts, dev, reps, chunk=None):
    """One operating point: counted first call (counts, tiers, launches),
    then ``reps`` warmed timed calls."""
    def call():
        return PRX.rx_chain_count(cfg, x, mpdu_len=mpdu_len, max_pkts=n_pkts,
                                  chunk=chunk)
    res, moved = timing.with_counters(call, dev)
    n_ok, n_det = (int(v) for v in res)
    t = timing.call_ms(call, dev, reps)
    return {"n_ok": n_ok, "n_det": n_det, "path": timing.decode_path(moved),
            **timing.kernel_launches(moved),
            "ms_per_batch": t["median_ms"], "q1_ms": t["q1_ms"],
            "q3_ms": t["q3_ms"], "pkt_per_s": n_pkts / t["median_ms"] * 1e3,
            "msamp_per_s": x.shape[-1] / t["median_ms"] / 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = timing.require_device(a.device)
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf

    B = a.batch
    cfg, mpdu, _, _, streams = bench_streams(B)
    log(f"cfg: VHT mcs7 1ss, mpdu {len(mpdu)} B, psdu {cfg.psdu_len} B, "
        f"nsym {cfg.nsym}; stream {len(streams[SNR_HI]) / 1e6:.1f} M "
        f"samples ({B} packets) on {dev}")
    ref = ref_ceiling(cfg)
    pts = {}
    for snr, s in streams.items():
        pts[snr] = run_point(PRX, cfg, len(mpdu), from_numpy_cf(s[None], dev),
                             B, dev, a.reps)
        p = pts[snr]
        log(f"{snr:g} dB: {p['ms_per_batch']:.2f} ms/batch "
            f"(q1 {p['q1_ms']:.2f}, q3 {p['q3_ms']:.2f}), "
            f"{p['pkt_per_s']:,.0f} pkt/s, ok {p['n_ok']}/{B}, "
            f"det {p['n_det']}, path {p['path']}, launches {p['launches']}")
    hi, lo = pts[SNR_HI], pts[SNR_LO]
    if hi["n_ok"] < 0.99 * B:
        log("WARNING: decode success below 99%, numbers may be invalid")
    device = timing.device_info(dev)
    timing.write_json(timing.out_path("bench_envelope.json", a.out), {
        "config": f"VHT mcs7 1ss 500B, B={B}, one device",
        "device": device, "reps": a.reps,
        "ref_ceiling_pkt_per_s": ref,
        "high_snr_32dB": {**hi, "vs_ref_ceiling": hi["pkt_per_s"] / ref},
        "low_snr_floor_18dB": {**{k: v for k, v in lo.items()
                                  if k != "pkt_per_s"},
                               "pkt_per_s_processed": lo["pkt_per_s"],
                               "vs_ref_ceiling": lo["pkt_per_s"] / ref},
    })
    print(json.dumps({
        "metric": "rx_full_chain_packets_per_s_per_chip_vht_mcs7_500B",
        "value": hi["pkt_per_s"], "unit": "packets/s",
        "vs_baseline": hi["pkt_per_s"] / ref, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
