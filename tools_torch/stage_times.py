#!/usr/bin/env python3
"""Where the time of the transmit and MU-STA receive paths goes.

    python3 tools_torch/stage_times.py [REPS]

Builds ``chip_smoke.py``'s MU traffic through that script's own helpers
(NDP sounding, then 2048 zero-forcing precoded two-user PPDUs, user 0 VHT
MCS3, user 1 MCS2, as station 0 hears them, at 32 dB and at the SNR where
rows leave the algebraic fast path) and its
4096-packet VHT MCS7 transmit batch on the card, then for
``rx_chain_count_mu`` at both SNRs, ``tx_batch`` and ``tx_batch_mu``:

* the whole call, warmed, host clock around REPS (default 5) calls each
  ending in a synchronize (median);
* the stages inside it: each stage function is wrapped by a timer that
  synchronizes before and after, so a stage's time is its own device work
  plus its launch overhead, and nested stages are listed under their
  callers (inclusive times; the sum exceeds the unsynchronized call);
* the device's busy time and the number of device kernels of one call
  (``torch.profiler``), beside the call's wall time.

Prints one JSON line per path.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


class StageTimer:
    """Wraps module functions with synchronized timers; ``stack`` gives
    every stage its callers' names as a prefix."""

    def __init__(self, torch):
        self.torch = torch
        self.ms: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.stack: list[str] = []
        self._undo = []

    def wrap(self, module, name: str):
        fn = getattr(module, name)

        def timed(*a, **k):
            self.stack.append(name)
            key = " > ".join(self.stack)
            self.torch.cuda.synchronize()
            tic = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.torch.cuda.synchronize()
                self.ms[key] = self.ms.get(key, 0.0) + 1e3 * (
                    time.perf_counter() - tic)
                self.calls[key] = self.calls.get(key, 0) + 1
                self.stack.pop()
        setattr(module, name, timed)
        self._undo.append((module, name, fn))

    def unwrap(self):
        for module, name, fn in reversed(self._undo):
            setattr(module, name, fn)
        self._undo.clear()

    def report(self, reps: int) -> dict:
        return {k: {"ms": round(v / reps, 3), "calls": self.calls[k] // reps}
                for k, v in self.ms.items()}


def whole_call_ms(torch, fn, reps: int) -> float:
    fn()
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - tic))
    return statistics.median(out)


def device_busy(torch, fn) -> dict:
    """Device busy ms and device kernel count of one call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - tic)
    busy_us, n_kernels = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            busy_us += t
            n_kernels += e.count
    return {"device_busy_ms": round(busy_us / 1e3, 3),
            "device_kernels": n_kernels,
            "profiled_wall_ms": round(wall, 3)}


def measure(torch, fn, stages, reps: int) -> dict:
    out = {"call_ms": round(whole_call_ms(torch, fn, reps), 3)}
    out.update(device_busy(torch, fn))
    timer = StageTimer(torch)
    for module, name in stages:
        timer.wrap(module, name)
    try:
        for _ in range(reps):
            fn()
    finally:
        timer.unwrap()
    out["stages"] = timer.report(reps)
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("stage_times: needs a CUDA card", file=sys.stderr)
        return 2
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    sys.path.insert(0, str(HERE))
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
    CF = CX.CF
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(53)

    # chip_smoke's phase (g): the same sounding, Q, PPDUs and channel (its
    # helpers, drawn from the same generator in the same order); only the
    # transmit call differs: tx_batch_mu on device tensors, to be timed
    h_sta, q56 = CS.mu_sounding(PRX, PTX.TxEngine(), rng)
    mu, sent, _, arrs, seeds_np = CS.mu_traffic(rng)
    seeds = torch.from_numpy(seeds_np).to(dev)
    pays = tuple(torch.from_numpy(a).to(dev) for a in arrs)
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
                 (OF, "fft_syms"), (OF, "equalize_and_demap"),
                 (OF, "deinterleave_deparse"), (PRX, "adaptive_decode"),
                 (V, "viterbi_decode"), (OF, "descramble_bits"),
                 (OF, "bits_to_bytes_batch"), (CRC, "fcs_ok_batch")]
    for snr in (CS.SNR_HI, CS.SNR_MU_LO):
        stream = CS.add_noise(torch, CF, base, rms, snr, gen)
        counts = []

        def rx():
            counts[:] = [int(x) for x in PRX.rx_chain_count_mu(
                cfg, stream, n_total=2, own=0, mpdu_len=len(sent[0][0]),
                max_pkts=CS.B_MU)]
        res = measure(torch, rx, rx_stages, reps)
        print(json.dumps({"path": f"rx_chain_count_mu B={CS.B_MU} user 0 VHT "
                          f"mcs3 {snr:g} dB", "n_ok_n_det": counts,
                          "card": card, "reps": reps, **res}), flush=True)

    tx_stages = [(PTX, "_qam_streams"), (PTX, "_scramble_batch"),
                 (PTX, "_bcc_encode_batch"), (PTX, "_data_grids"),
                 (PTX, "_apply_q_grids"), (PTX, "idft64"), (PTX, "_gi80"),
                 (PTX, "_finish_wave")]
    res = measure(torch, lambda: PTX.tx_batch_mu(mu, pays, seeds, q_d),
                  tx_stages, reps)
    print(json.dumps({"path": f"tx_batch_mu B={CS.B_MU} mcs3 + mcs2",
                      "card": card, "reps": reps, **res}), flush=True)
    _, _, arr = CS.random_ampdus(rng, CS.B, 500)
    su = PhyConfig(Fmt.VHT, CS.MCS, 1, arr.shape[1], ampdu=True)
    arr_d = torch.from_numpy(arr).to(dev)
    seeds4 = torch.from_numpy((np.arange(CS.B) % 127 + 1).astype(np.int64)
                              ).to(dev)
    res = measure(torch, lambda: PTX.tx_batch(su, arr_d, seeds4), tx_stages,
                  reps)
    print(json.dumps({"path": f"tx_batch B={CS.B} VHT mcs{CS.MCS} 530 B MPDU",
                      "card": card, "reps": reps, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
