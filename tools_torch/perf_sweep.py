#!/usr/bin/env python3
"""PER against SNR: the reference's evaluation protocol on the port.

    python3 tools_torch/perf_sweep.py [--formats L HT VHT] [--mcs M ...]
        [--n 100] [--snrs 0 31 1] [--payload 500] [--nss 1|2] [--mu]
        [--device cuda] [--out results_torch/per_results.json] [--dump DIR]

The protocol of ``tools_tpu/perf_sweep.py`` (the reference's
``perf_siso.py``): per MCS, n packets of a ``--payload``-byte payload, AWGN
calibrated against the signal RMS, SNR swept over ``arange(*--snrs)``; PER
is the share of packets whose MPDU fails the FCS, a missed trigger
counting as a lost packet. All SNR points of one MCS lie on one IQ
timeline (n packets a segment, 400-sample gaps, 800 Hz CFO) that the
known-config chain decodes in one call: ``rx_chain_ok`` for SISO and for
``--nss 2`` (HT MCS8-15 and VHT 2 SS through a mildly coupled 2x2
channel, two antennas), ``rx_chain_ok_mu`` for ``--mu`` (two VHT users at
the swept MCS from ``TxEngine.tx_mu`` with a zero-forcing Q from fixed
per-station 1x2 channels; station 0 decodes its own stream). Detections
map back to their slots by sync position. ``default_rng(2026)`` draws in
the JAX tool's order, so both tools lay the same timelines.

Writes the PER of every configuration to ``--out`` after each MCS (a cut
run keeps what it has), with the detected count, the decode tiers taken,
K1/K2's launches and the time of the decode call. ``--dump DIR`` also
writes each configuration's per-row results (ok, ltf_idx, valid), its
per-slot ok flags and the SHA-256 of its timeline to ``DIR/<name>.npz``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools_torch import timing  # noqa: E402
from tools_torch.bench import ADDR as ADDR0  # noqa: E402

ADDR1 = ("02:00:00:00:00:11", "00:c0:ca:b1:5b:e1", "02:00:00:00:00:11")
CFO_HZ = 800.0
MCS_BY_FMT = {1: {"L": range(8), "HT": range(8), "VHT": range(9)},
              2: {"HT": range(8, 16), "VHT": range(9)}}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def max_pkts_for(n_slots: int) -> int:
    """Rows the chain decodes: 5/4 of the slots, in 128s, so that false
    triggers (mid-packet, noise) do not evict real packets at the end of
    the timeline; they decode to garbage and fail the slot mapping."""
    return -(-(n_slots * 5) // (4 * 128)) * 128


def build_timeline(w, rms: float, snrs, n: int, rng):
    """One timeline of ``len(snrs)`` segments of ``n`` packets each.

    ``w``: (nrx, n_wave) complex64 waveform as received (CFO applied).
    Segment s is complex AWGN at ``rms / 10**(snrs[s]/20)`` drawn from
    ``rng`` (real parts, then imaginary parts, (nrx, seg) each) with
    copies of ``w`` added at 512 + i * spacing; spacing = n_wave + 400,
    seg = n * spacing + 1024.  Returns (stream (nrx, len(snrs) * seg)
    complex64, seg, spacing)."""
    nrx, n_wave = w.shape
    spacing = n_wave + 400
    seg = n * spacing + 1024
    stream = np.empty((nrx, len(snrs) * seg), np.complex64)
    for s, snr in enumerate(snrs):
        namp = rms / 10 ** (snr / 20)
        block = (rng.normal(size=(nrx, seg)) + 1j * rng.normal(size=(nrx, seg))
                 ).astype(np.complex64) * (namp / np.sqrt(2))
        for i in range(n):
            o = 512 + i * spacing
            block[:, o: o + n_wave] += w
        stream[:, s * seg: (s + 1) * seg] = block
    return stream, seg, spacing


def slot_ok(ok, ltf_idx, valid, seg: int, spacing: int, n: int,
            nsnr: int) -> np.ndarray:
    """(nsnr * n,) bool: a slot is ok when a valid, FCS-ok detection's
    sync position falls within 300 samples of the slot's L-LTF (186
    samples past its start)."""
    out = np.zeros(nsnr * n, bool)
    for j in np.flatnonzero(np.asarray(valid) & np.asarray(ok)):
        s, rem = divmod(int(ltf_idx[j]), seg)
        i = (rem - 512) // spacing
        if 0 <= i < n and abs(rem - 512 - i * spacing - 186) < 300:
            out[s * n + i] = True
    return out


def siso_wave(fname: str, mcs: int, nss: int, n_payload: int, rng):
    """(cfg, mpdu_len for the chain, w (nss, n) complex64 with CFO, rms)
    of one configuration, drawn from ``rng`` as the JAX tool draws: the
    payload, then (nss = 2) the 2x2 channel."""
    from gr_ieee80211_tpu_torch.gold import channel, mac, tx
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    fmt = Fmt[fname]
    payload = bytes(rng.integers(0, 256, n_payload, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, *ADDR0, 7)
    if fmt == Fmt.VHT:
        psdu = mac.ampdu_aggregate_vht([mpdu])
        cfg = PhyConfig(fmt, mcs, nss, len(psdu), ampdu=True)
    else:
        psdu = mpdu
        cfg = PhyConfig(fmt, mcs, nss, len(psdu))
    kw = dict(group_id=0, partial_aid=0) if fmt == Fmt.VHT else {}
    wave = tx.tx_waveform(cfg, psdu, **kw)             # (nss, n)
    if nss == 2:
        h2 = np.eye(2) + 0.25 * (rng.normal(size=(2, 2))
                                 + 1j * rng.normal(size=(2, 2)))
        wave = h2 @ wave
    rms = float(np.sqrt(np.mean(np.abs(wave[0]) ** 2)))
    w = np.stack([channel.apply_cfo(wv, CFO_HZ) for wv in wave]
                 ).astype(np.complex64)
    return cfg, len(mpdu) if fmt == Fmt.VHT else 0, w, rms


def mu_channels(rng):
    """Station 0's and 1's flat 1x2 channels and the zero-forcing Q grid
    (64, 2, 2) from their rows (the JAX tool's first draws)."""
    from gr_ieee80211_tpu_torch.gold import sounding
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
             / np.sqrt(2) for _ in range(2)]
    h_rows = np.repeat(np.stack(h_sta)[:, 0][:, :, None], 56, axis=2)
    return h_sta, sounding.q_to_grid(sounding.zf_q(h_rows))


def mu_wave(mcs: int, n_payload: int, rng, txe, h0, bfq):
    """(cfg of user 0 for the chain, its mpdu_len, w (1, n) complex64 as
    station 0 hears the PPDU with CFO, rms): both users at ``mcs``, user 1
    with the payload's first 300 bytes."""
    from gr_ieee80211_tpu_torch.gold import channel, mac
    from gr_ieee80211_tpu_torch.spec.params import Fmt, MuConfig, PhyConfig
    payload = bytes(rng.integers(0, 256, n_payload, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, *ADDR0, 7)
    psdu0 = mac.ampdu_aggregate_vht([mpdu])
    psdu1 = mac.ampdu_aggregate_vht([mac.qos_data_frame(payload[:300],
                                                        *ADDR1, 8)])
    mu = MuConfig((PhyConfig(Fmt.VHT, mcs, 1, len(psdu0), ampdu=True),
                   PhyConfig(Fmt.VHT, mcs, 1, len(psdu1), ampdu=True)),
                  group_id=2)
    wave2 = txe.tx_mu(mu, [[psdu0], [psdu1]], bfq)[0]   # (2, n)
    wave = channel.apply_cfo((h0 @ wave2)[0], CFO_HZ).astype(np.complex64)
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    u0 = mu.users[0]
    cfg = PhyConfig(Fmt.VHT, mcs, 1, u0.psdu_len, ampdu=True, mu_nsym=mu.nsym)
    return cfg, len(mpdu), wave[None], rms


def decode(PRX, cfg, x, nrx: int, mpdu_len: int, max_pkts: int, mu: bool):
    """(ok, ltf_idx, valid) numpy arrays of the known-config chain."""
    if mu:
        out = PRX.rx_chain_ok_mu(cfg, x, n_total=2, own=0, nrx=1,
                                 mpdu_len=mpdu_len, max_pkts=max_pkts)
    else:
        out = PRX.rx_chain_ok(cfg, x, nrx=nrx, mpdu_len=mpdu_len,
                              max_pkts=max_pkts)
    return tuple(t.cpu().numpy() for t in out)


def sweep_one(PRX, cfg, mpdu_len, w, rms, snrs, n, rng, dev, mu=False):
    """Lay, decode and score one configuration: (entry, dump arrays)."""
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
    stream, seg, spacing = build_timeline(w, rms, snrs, n, rng)
    max_pkts = max_pkts_for(len(snrs) * n)
    x = from_numpy_cf(stream, dev)
    tic = time.perf_counter()
    (ok, ltf_idx, valid), moved = timing.with_counters(
        lambda: decode(PRX, cfg, x, w.shape[0], mpdu_len, max_pkts, mu), dev)
    ms = 1e3 * (time.perf_counter() - tic)
    slots = slot_ok(ok, ltf_idx, valid, seg, spacing, n, len(snrs))
    per = [1.0 - float(slots[s * n:(s + 1) * n].mean())
           for s in range(len(snrs))]
    entry = {"snr_db": [float(v) for v in snrs], "per": per,
             "n_det": int(valid.sum()), "max_pkts": max_pkts,
             "path": sorted(set(timing.decode_path(moved))), "decode_ms": ms,
             **timing.kernel_launches(moved)}
    dump = {"ok": ok, "ltf_idx": ltf_idx, "valid": valid, "ok_slot": slots,
            "seg": seg, "spacing": spacing,
            "digest": hashlib.sha256(stream.tobytes()).hexdigest()}
    return entry, dump


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--formats", nargs="+", default=["L", "HT", "VHT"])
    ap.add_argument("--mcs", nargs="+", type=int, default=None)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--snrs", nargs=3, type=float, default=[0, 31, 1])
    ap.add_argument("--payload", type=int, default=500)
    ap.add_argument("--nss", type=int, default=1, choices=(1, 2),
                    help="2: the SU-MIMO sweep, HT MCS8-15 / VHT 2 SS "
                         "through a mildly coupled 2x2 channel")
    ap.add_argument("--mu", action="store_true",
                    help="the 2-user MU-MIMO downlink sweep: tx_mu with a "
                         "ZF Q from the stations' channels, station 0 "
                         "decodes its stream with rx_chain_ok_mu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--dump", default=None,
                    help="directory for each configuration's per-row and "
                         "per-slot results (.npz)")
    a = ap.parse_args(argv)
    dev = timing.require_device(a.device)
    from gr_ieee80211_tpu_torch.models import rx as PRX
    out = timing.out_path("per_results.json", a.out)
    if a.dump:
        Path(a.dump).mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(2026)
    snrs = np.arange(*a.snrs)
    results = {"device": timing.device_info(dev)}
    if a.mu:
        from gr_ieee80211_tpu_torch.models.tx import TxEngine
        h_sta, bfq = mu_channels(rng)
        txe = TxEngine(device=dev)
        todo = [("MU", mcs) for mcs in (a.mcs or range(9))]
    else:
        formats = a.formats
        if a.nss == 2 and formats == ["L", "HT", "VHT"]:
            formats = ["HT", "VHT"]
        todo = [(f, mcs) for f in formats
                for mcs in (a.mcs or MCS_BY_FMT[a.nss][f])]
    for fname, mcs in todo:
        tic = time.time()
        if a.mu:
            name = f"MU_mcs{mcs}_sta0"
            cfg, ml, w, rms = mu_wave(mcs, a.payload, rng, txe, h_sta[0], bfq)
        else:
            name = f"{fname}_mcs{mcs}" + ("_2ss" if a.nss == 2 else "")
            cfg, ml, w, rms = siso_wave(fname, mcs, a.nss, a.payload, rng)
        entry, dump = sweep_one(PRX, cfg, ml, w, rms, snrs, a.n, rng, dev,
                                mu=a.mu)
        results[name] = {"snr_db": entry.pop("snr_db"),
                         "per": entry.pop("per"), "payload": a.payload,
                         "n": a.n, **({"users": 2} if a.mu else {}), **entry}
        log(f"{name}: {time.time() - tic:.1f}s  "
            + " ".join(f"{p:.2f}" for p in results[name]["per"])
            + f"  K1 {entry['launches']['acs_sweep']}")
        if a.dump:
            np.savez(Path(a.dump) / f"{name}.npz", **dump)
        timing.write_json(out, results)     # a cut run keeps what it has
    print(json.dumps({"points": sum(len(v["per"]) for v in results.values()
                                    if isinstance(v, dict)),
                      "out": str(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
