#!/usr/bin/env python3
"""Where the time of the port's receive and transmit paths goes.

    python3 tools_torch/stage_times.py [txmu] [REPS]
    python3 tools_torch/stage_times.py chain [REPS] [--batch 4096]
    python3 tools_torch/stage_times.py canon [REPS] [--batch 4096]
    python3 tools_torch/stage_times.py fallback [REPS] [--batch 4096]
        [--device cuda] [--out results_torch/stage_times_<mode>.json]

Modes:

* ``txmu`` (the default; needs a card): ``chip_smoke.py``'s MU traffic
  (NDP sounding, 2048 zero-forcing precoded two-user PPDUs, user 0 VHT
  MCS3, user 1 MCS2, as station 0 hears them) through
  ``rx_chain_count_mu`` at 32 dB and where rows leave the algebraic fast
  path, and its transmit batches through ``tx_batch`` (4096 VHT MCS7) and
  ``tx_batch_mu``;
* ``chain``: ``rx_chain_count`` on ``bench.py``'s stream (VHT MCS7, 530 B
  MPDU, B packets) at 32 and 18 dB, with detect and dedup, sync (window
  gather, coarse CFO, LTF metric and fine CFO), demod (derotate, channel
  estimate with its SISO refinement (K7 on the card, one stage), dd gate,
  the dd pass's symbol grids and refinement, the demodulation: symbol
  DFTs, pilot phase, equalizer, demap and deinterleave (K8 on the card,
  one stage)), decode (GF(2) inverse + syndrome,
  the tier taken, K1 + K2 inside ``viterbi_decode``), descramble, bytes
  and CRC as stages;
* ``canon``: the engine's canonical bucket (VHT MCS5 packets of three
  lengths sharing one rounded-up trellis) through ``_payload_core`` with
  ``n_real`` (the fast path) and without (every row falls back to the
  Viterbi), and the count of PSDUs equal to the bytes sent;
* ``fallback``: the decode tiers alone at the bench's trellis: the
  inverse + syndrome, ``adaptive_decode`` with 0, 8 and 300 failing rows,
  the full K1 + K2 decode, a 128-row gather, the 128-row decode and a
  128-row scatter; each decode's rows are compared with the encoded
  message (clean rows) or with the full decode's bits (rows with flipped
  bits: a windowed tier may decode an uncorrectable row differently).

For each timed path: the whole call, warmed, median and quartiles of REPS
calls (CUDA events on the card, the host clock around a synchronized
call on the CPU); on the card the device's busy time, kernel count and
busiest kernels of one call (``torch.profiler``); and the stages inside
it: each stage function is wrapped by a timer that synchronizes the
device before and after, so a stage's time is its own device work plus
its launch overhead, with nested stages listed under their callers
(inclusive times; the sum exceeds the unsynchronized call). Prints one
JSON line per path and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from tools_torch import timing  # noqa: E402


class StageTimer:
    """Wraps module functions (or class methods) with timers that
    synchronize ``dev``; ``stack`` gives every stage its callers' names
    as a prefix."""

    def __init__(self, dev):
        self.dev = dev
        self.ms: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.stack: list[str] = []
        self._undo = []

    def wrap(self, owner, name: str):
        fn = getattr(owner, name)

        def timed(*a, **k):
            self.stack.append(name)
            key = " > ".join(self.stack)
            timing.synchronize(self.dev)
            tic = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                timing.synchronize(self.dev)
                self.ms[key] = self.ms.get(key, 0.0) + 1e3 * (
                    time.perf_counter() - tic)
                self.calls[key] = self.calls.get(key, 0) + 1
                self.stack.pop()
        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def unwrap(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo.clear()

    def report(self, per: int) -> dict:
        """ms and calls of each stage, divided by ``per`` (the calls or
        blocks the timer saw)."""
        return {k: {"ms": v / per, "calls": self.calls[k] / per}
                for k, v in self.ms.items()}


def device_busy(dev, fn) -> dict:
    """Device busy ms, device kernel count and the five busiest kernels of
    one call, summed over the device's own events (on the card; on the
    CPU: not measured)."""
    if dev.type != "cuda":
        return {"device_busy_ms": None, "device_kernels": None}
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - tic)
    busy_us, n_kernels, top = 0.0, 0, []
    for e in prof.key_averages():
        # the device's own events (kernels, copies); the host operators
        # that launched them carry the same time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.self_device_time_total
        busy_us += t
        n_kernels += e.count
        top.append((t, e.key, e.count))
    top.sort(reverse=True)
    return {"device_busy_ms": busy_us / 1e3, "device_kernels": n_kernels,
            "profiled_wall_ms": wall,
            "busiest": [{"kernel": k[:80], "ms": t / 1e3, "count": c}
                        for t, k, c in top[:5]]}


def measure(dev, fn, stages, reps: int) -> dict:
    """Whole-call time, device busy share and stage table of ``fn``."""
    t = timing.call_ms(fn, dev, reps)
    out = {"call_ms": t["median_ms"], "call_q1_ms": t["q1_ms"],
           "call_q3_ms": t["q3_ms"], **device_busy(dev, fn)}
    timer = StageTimer(dev)
    for owner, name in stages:
        timer.wrap(owner, name)
    try:
        for _ in range(reps):
            fn()
    finally:
        timer.unwrap()
    out["stages"] = timer.report(reps)
    return out


def chain_stages():
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.ops import crc as CRC
    from gr_ieee80211_tpu_torch.ops import fastdecode as FD
    from gr_ieee80211_tpu_torch.ops import frontend as FE
    from gr_ieee80211_tpu_torch.ops import ofdm as OF
    return [(PRX, "_detect_sync"), (PRX, "_triggers"),
            (FE, "stf_metric_strided"), (FE, "detect_plateaus_strided"),
            (FE, "dedup_triggers_device"), (PRX, "_sync_core"),
            (FE, "gather_windows_bf16"), (FE, "coarse_cfo_batch"),
            (FE, "ltf_fine_sync_cfo"), (FE, "_ltf_metric"),
            (PRX, "_payload_core"), (FE, "derotate_batch"),
            (OF, "payload_chanest"), (PRX, "_dd_gate"),
            (OF, "payload_grids"), (OF, "refine_chanest_data"),
            (OF, "payload_demod"), (PRX, "adaptive_decode"),
            (FD, "inverse_and_syndrome"), (FD, "_tile"), (FD, "_win_tile"),
            (FD, "_mism_recompute"), (FD, "_full"), (FD, "viterbi_decode"),
            (FD, "decode_window_rows"), (OF, "descramble_bits"),
            (OF, "bits_to_bytes_batch"), (CRC, "fcs_ok_batch")]


def mode_chain(dev, reps, a) -> list[dict]:
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
    from tools_torch import bench
    B = a.batch
    cfg, mpdu, _, _, streams = bench.bench_streams(B)
    rows = []
    for snr, s in streams.items():
        x = from_numpy_cf(s[None], dev)

        def call():
            return PRX.rx_chain_count(cfg, x, mpdu_len=len(mpdu), max_pkts=B)
        res, moved = timing.with_counters(call, dev)
        rows.append({"path": f"rx_chain_count B={B} VHT mcs7 530 B MPDU "
                             f"{snr:g} dB",
                     "n_ok_n_det": [int(v) for v in res],
                     "tiers": timing.decode_path(moved),
                     **timing.kernel_launches(moved),
                     **measure(dev, call, chain_stages(), reps)})
    return rows


def canon_stream(B: int):
    """(canon cfg, stream, ltf_idx, n_real, psdus): ``profile_canon``'s
    VHT MCS5 packets of 230, 245 and 260 B payloads in turn (700 Hz CFO,
    32 dB, ``default_rng(9)``), whose trellises round up to one rung."""
    from gr_ieee80211_tpu_torch.gold import channel, mac, tx
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    from tools_torch import bench
    rng = np.random.default_rng(9)
    waves, cfgs, psdus = [], [], []
    for plen in (230, 245, 260):
        body = bytes(rng.integers(0, 256, plen, dtype=np.uint8))
        am = mac.ampdu_aggregate_vht([mac.qos_data_frame(body, *bench.ADDR,
                                                         3)])
        cfg = PhyConfig(Fmt.VHT, 5, 1, len(am), ampdu=True)
        waves.append(channel.apply_cfo(tx.tx_waveform(cfg, am)[0], 700.0))
        cfgs.append(cfg)
        psdus.append(am)
    canon = PRX.canonical_cfg(cfgs[0])
    if any(PRX.canonical_cfg(c) != canon for c in cfgs):
        raise RuntimeError("the three lengths no longer share a rung")
    spacing = max(len(w) for w in waves) + 400
    stream = np.zeros(B * spacing + 4096, np.complex64)
    ltf_idx = np.empty(B, np.int64)
    n_real = np.empty(B, np.int32)
    for i in range(B):
        k = i % 3
        p = 1024 + i * spacing
        stream[p: p + len(waves[k])] = waves[k]
        ltf_idx[i] = p + 188
        n_real[i] = cfgs[k].n_trellis
    rms = float(np.sqrt(np.mean(np.abs(waves[0]) ** 2)))
    stream = bench.noisy(stream, rms, 32.0, rng)
    return canon, cfgs, stream, ltf_idx, n_real, psdus


def mode_canon(dev, reps, a) -> list[dict]:
    import torch
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
    B = a.batch
    canon, cfgs, stream, ltf_idx, n_real, psdus = canon_stream(B)
    x = from_numpy_cf(stream[None], dev)
    li = torch.from_numpy(ltf_idx.astype(np.int32)).to(dev)
    cfo = torch.full((B,), 700.0, dtype=torch.float32, device=dev)
    nr = torch.from_numpy(n_real).to(dev)
    out = {"path": f"canonical bucket B={B}", "canon_nsym": canon.nsym,
           "canon_n_trellis": canon.n_trellis,
           "real_nsym": [c.nsym for c in cfgs]}
    for name, n_real_t in (("with_n_real", nr), ("without_n_real", None)):
        def call():
            return PRX._payload_core(canon, x, li, cfo, nrx=1,
                                     n_real=n_real_t)["psdu"]
        psdu, moved = timing.with_counters(call, dev)
        psdu = psdu.cpu().numpy()
        exact = sum(1 for i in range(B)
                    if psdu[i][: len(psdus[i % 3])].tobytes() == psdus[i % 3])
        t = timing.call_ms(call, dev, reps)
        out[name] = {"ms": t["median_ms"], "q1_ms": t["q1_ms"],
                     "q3_ms": t["q3_ms"], "tiers": timing.decode_path(moved),
                     "psdus_exact": exact, **timing.kernel_launches(moved)}
    out["speedup"] = out["without_n_real"]["ms"] / out["with_n_real"]["ms"]
    return [out]


def fallback_inputs(B: int):
    """(cfg, messages (8, T), clean LLRs (B, n_kept), bad(n) -> LLRs with
    ``n`` rows carrying 40 flipped hard bits each): ``profile_fallback``'s
    inputs (``default_rng(0)``)."""
    from gr_ieee80211_tpu_torch.gold import bits as GB
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    cfg = PhyConfig(Fmt.VHT, 7, 1, 520, ampdu=True)
    T_ = cfg.n_trellis
    rng = np.random.default_rng(0)
    msg = rng.integers(0, 2, (8, T_)).astype(np.uint8)
    msg[:, -6:] = 0
    base = np.stack([2.0 * GB.bcc_encode_punct(m, cfg.cr).astype(np.float32)
                     - 1.0 for m in msg])
    n_kept = base.shape[1]
    clean = np.tile(base, (-(-B // 8), 1))[:B] + 0.05 * rng.normal(
        size=(B, n_kept)).astype(np.float32)

    def with_bad(n_bad):
        x = clean.copy()
        for r in range(min(n_bad, B // 2)):
            pos = rng.integers(0, n_kept, 40)
            x[r, pos] = -x[r, pos]
        return x
    return cfg, msg, clean.astype(np.float32), with_bad


def mode_fallback(dev, reps, a) -> list[dict]:
    import torch
    from gr_ieee80211_tpu_torch.ops import fastdecode as FD
    from gr_ieee80211_tpu_torch.ops import viterbi as V
    from gr_ieee80211_tpu_torch.ops import viterbi_kernels as VK
    B = a.batch
    cfg, msg, clean, with_bad = fallback_inputs(B)
    T_, cr = cfg.n_trellis, cfg.cr
    want = torch.from_numpy(np.tile(msg, (-(-B // 8), 1))[:B]).to(dev)
    x0 = torch.from_numpy(clean).to(dev)
    x8 = torch.from_numpy(with_bad(8).astype(np.float32)).to(dev)
    x300 = torch.from_numpy(with_bad(300).astype(np.float32)).to(dev)
    k = min(128, B)
    rows_idx = torch.arange(k, device=dev)
    d8 = FD.inverse_and_syndrome(x0, cr, T_)[0]
    bits_k = torch.zeros((k, T_), dtype=torch.uint8, device=dev)

    def scatter():
        d = d8.clone()
        d[rows_idx] = bits_k
        return d

    def full(x):
        return VK.viterbi_decode(V.depuncture(x, cr, T_))
    # each decode is compared with the message on clean rows and with the
    # full Viterbi's bits where rows carry flipped bits (a windowed tier
    # may end an uncorrectable row's path differently)
    cases = {
        "syn": (lambda: FD.inverse_and_syndrome(x0, cr, T_)[1], None),
        "fast": (lambda: FD.adaptive_decode(x0, cr, T_), lambda: want),
        "tile8": (lambda: FD.adaptive_decode(x8, cr, T_), lambda: full(x8)),
        "tile300": (lambda: FD.adaptive_decode(x300, cr, T_),
                    lambda: full(x300)),
        "full": (lambda: full(x0), lambda: want),
        "gather": (lambda: x8[rows_idx], None),
        f"seg{k}": (lambda: full(x8[:k]), lambda: FD.adaptive_decode(
            x8[:k], cr, T_)),
        "scatter": (scatter, None),
    }
    out = {"path": f"decode tiers B={B} T={T_} cr={cr}", "B": B, "T": T_,
           "cr": cr}
    for name, (fn, ref) in cases.items():
        res, moved = timing.with_counters(fn, dev)
        t = timing.call_ms(fn, dev, reps)
        out[name] = {"ms": t["median_ms"], "q1_ms": t["q1_ms"],
                     "q3_ms": t["q3_ms"], **timing.kernel_launches(moved)}
        if name.startswith("tile"):
            out[name]["tiers"] = timing.decode_path(moved)
        if ref is not None:
            want_bits = ref()
            out[name]["rows_equal"] = int((res == want_bits).all(dim=1).sum())
            out[name]["rows"] = res.shape[0]
    return [out]


def mode_txmu(dev, reps, a) -> list[dict]:
    import torch
    import chip_smoke as CS
    from gr_ieee80211_tpu_torch.gold import sounding
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.models import tx as PTX
    from gr_ieee80211_tpu_torch.ops import cplx as CX
    from gr_ieee80211_tpu_torch.ops import crc as CRC
    from gr_ieee80211_tpu_torch.ops import frontend as FE
    from gr_ieee80211_tpu_torch.ops import ofdm as OF
    from gr_ieee80211_tpu_torch.ops import viterbi as V
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    if dev.type != "cuda":
        raise RuntimeError("txmu builds chip_smoke.py's traffic on the card")
    CF = CX.CF
    rng = np.random.default_rng(53)
    rows = []

    # chip_smoke's phase (g): the same sounding, Q, PPDUs and channel (its
    # helpers, drawn from the same generator in the same order); only the
    # transmit call differs: tx_batch_mu on device tensors, to be timed
    h_sta, q56 = CS.mu_sounding(PRX, PTX.TxEngine(), rng)
    mu, sent, _, arrs, seeds_np = CS.mu_traffic(rng)
    seeds = torch.from_numpy(seeds_np).to(dev)
    pays = tuple(torch.from_numpy(x).to(dev) for x in arrs)
    q_d = CX.from_numpy_cf(sounding.q_to_grid(q56), dev)
    waves = PTX.tx_batch_mu(mu, pays, seeds, q_d)
    heard = CS.mu_heard(torch, CF, waves, h_sta[0][0])
    heard = CF(heard.re.float(), heard.im.float())
    base, rms, _ = CS.lay_stream(torch, CF, heard, CS.CFO_MU_HZ)
    gen = torch.Generator(device=dev).manual_seed(59)
    cfg = CS.mu_user_cfg(mu, 0)
    rx_stages = [(PRX, "_detect_sync"), (PRX, "_triggers"),
                 (PRX, "_sync_core"), (PRX, "_mu_sigb_core"),
                 (PRX, "_payload_core_mu"), (PRX, "_sigb_crc_ok"),
                 (FE, "derotate_batch"), (OF, "nl_chanest"),
                 (OF, "fft_syms"), (OF, "payload_demod"),
                 (PRX, "adaptive_decode"),
                 (V, "viterbi_decode"), (OF, "descramble_bits"),
                 (OF, "bits_to_bytes_batch"), (CRC, "fcs_ok_batch")]
    for snr in (CS.SNR_HI, CS.SNR_MU_LO):
        stream = CS.add_noise(torch, CF, base, rms, snr, gen)
        counts = []

        def rx():
            counts[:] = [int(x) for x in PRX.rx_chain_count_mu(
                cfg, stream, n_total=2, own=0, mpdu_len=len(sent[0][0]),
                max_pkts=CS.B_MU)]
        res = measure(dev, rx, rx_stages, reps)
        rows.append({"path": f"rx_chain_count_mu B={CS.B_MU} user 0 VHT "
                             f"mcs3 {snr:g} dB", "n_ok_n_det": counts, **res})

    tx_stages = [(PTX, "_qam_streams"), (PTX, "_scramble_batch"),
                 (PTX, "_bcc_encode_batch"), (PTX, "_data_grids"),
                 (PTX, "_apply_q_grids"), (PTX, "idft64"), (PTX, "_gi80"),
                 (PTX, "_finish_wave")]
    rows.append({"path": f"tx_batch_mu B={CS.B_MU} mcs3 + mcs2",
                 **measure(dev, lambda: PTX.tx_batch_mu(mu, pays, seeds, q_d),
                           tx_stages, reps)})
    _, _, arr = CS.random_ampdus(rng, CS.B, 500)
    su = PhyConfig(Fmt.VHT, CS.MCS, 1, arr.shape[1], ampdu=True)
    arr_d = torch.from_numpy(arr).to(dev)
    seeds4 = torch.from_numpy((np.arange(CS.B) % 127 + 1).astype(np.int64)
                              ).to(dev)
    rows.append({"path": f"tx_batch B={CS.B} VHT mcs{CS.MCS} 530 B MPDU",
                 **measure(dev, lambda: PTX.tx_batch(su, arr_d, seeds4),
                           tx_stages, reps)})
    return rows


MODES = {"txmu": mode_txmu, "chain": mode_chain, "canon": mode_canon,
         "fallback": mode_fallback}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in MODES:
        argv.insert(0, "txmu")          # the original form: [REPS]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=sorted(MODES))
    ap.add_argument("reps", type=int, nargs="?", default=5)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    dev = timing.require_device(a.device)
    device = timing.device_info(dev)
    rows = MODES[a.mode](dev, a.reps, a)
    for r in rows:
        print(json.dumps({**r, "device": device, "reps": a.reps}), flush=True)
    timing.write_json(timing.out_path(f"stage_times_{a.mode}.json", a.out),
                      {"mode": a.mode, "device": device, "reps": a.reps,
                       "paths": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
