#!/usr/bin/env python3
"""Drive the PyTorch port's receive chain, engine, transmitter, MU-MIMO
sounding loop, streaming runtime and sharded programs on one CUDA card and
check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. device: require a CUDA card; print ``nvidia-smi``'s name and power limit;
2. build: compile every kernel source (csrc/*.cu, one nvcc each, in
   parallel) into one library; print each kernel's registers, shared
   memory and spills as ``ptxas -v`` gave them (a spill fails);
3. kernels: the ACS (K1) and traceback (K2) kernels against their plain
   PyTorch twins on the card at the chain's shape (T = 4480, B = 4096)
   and at one engine bucket's (T = 4480, B = 64), pinned and uniform
   metrics, state-0 and argmax starts, exact equality, with CUDA-event
   times of both; then the packed ACS
   (K4) and traceback (K5) against their twins and against K1/K2 (planes
   == the packing of K1's, metrics and bits equal) at the same two shapes
   and at ragged batches of both block sizes ((128, 100) and (128, 1100):
   warps past the batch inside a block; (64, 37) and (64, 1037): rows
   that move byte by byte), timed like K1/K2; and the derotation (K3)
   against its twin at the bench's payload window (4096, 1984) and an
   MCS0 4095 B window (128, 100000), beside the factored-phasor form the
   chain runs; and the SIG-field scan Viterbi (K6) against its twin at
   eight SIG-B rows (8, 26), the front end's stacked SIG call at the top
   of the batch ladder (576, 48) and the data-parallel payload trellis
   (1024, 4480), both traceback starts, with CUDA-event and host times
   of both; and the payload channel estimate (K7) against its twin at
   the daemon cells' bucket shapes (every branch at one or two rows, one
   and two antennas) and at the chain's 4096 rows (the L and P-matrix
   estimates bit-equal, the refined ones within 1e-5 of the row's
   largest |h|), with CUDA-event and host times of both; and the payload
   demodulation (K8) against its twin at the daemon cells' buckets (every
   equalizer branch) and at the chain's (4096, 1) and (4096, 2) VHT MCS7
   buckets and (4096, 2) with two streams (every LLR within 1e-5 of the
   row's largest |LLR|, the share of symbols bit-equal), with CUDA-event
   and host times of both.  Each kernel's
   bound (the larger of its bytes over
   the card's memory rate and its operations over the float32 lane
   rate) is computed from these inputs;
4. chain: ``rx_chain_count`` on the 4096-packet VHT MCS7 500 B stream at
   32 dB (fast path; every packet detected, >= 99% pass FCS, sampled
   PSDUs equal the transmitted bytes) and at 18 dB (the Viterbi tiers
   run; the kernels' launch counters rise), with ms/batch and packets/s;
5. reference: a small 20 dB stream through the chain on the card and on
   the CPU (where the kernels' twins run) gives the same per-packet
   results;
6. engine: (a) the 32 dB bench stream through ``RxEngine.process``
   (4096/4096 detected, >= 99% ok, every ok packet's MPDU equals the
   sent one); (b) daemon-shaped traffic, 16 blocks of 1<<19 samples +
   16384 halo of mixed L/HT/VHT packets, A-MPDUs and NDPs at 30 dB, with
   homogeneous stretches that arm the speculative path, through
   begin_process/finish_process (every sent packet decoded once with its
   format, MCS and MPDUs), timed with and without speculation; (c) a
   2-antenna stream of HT MCS8-15 and VHT 2-SS packets; (d) a small mixed
   stream through the engine on the card and on the CPU, per-packet
   equal.  K1/K2 must launch in the engine runs;
7. transmit, single user (e): ``tx_batch`` / ``TxEngine.tx`` of 4096 VHT
   MCS7 A-MPDUs of one 530 B MPDU each, a different random payload and
   scrambler seed per packet, held to the numpy gold model on 8 of them
   (< 2e-6); the waveforms stay on the card, are laid into one stream
   (240-sample gaps, 900 Hz CFO, 32 dB AWGN from a seeded
   ``torch.Generator``) and go through ``rx_chain_count`` /
   ``rx_chain_ok``: 4096 detected, >= 99% pass FCS, sampled PSDUs equal
   the bytes sent;
8. transmit, MU (f): ``TxEngine.tx_mu`` of 2048 two-user PPDUs (both VHT
   MCS7, 530 B and 330 B MPDUs) with a seeded random Q, held to the gold
   model on 4 of them (< 2e-5);
9. the sounding loop (g): ``TxEngine.tx`` of a VHT 2-stream NDP -> two
   seeded 1x2 station channels -> each station's ``RxEngine.process`` ->
   its NDP channel estimate -> feedback rows -> zero-forcing Q ->
   ``TxEngine.tx_mu`` of 2048 PPDUs (user 0 MCS3, user 1 MCS2, payloads
   varied per packet) -> each station's channel, 300 Hz CFO, 32 dB AWGN ->
   ``rx_chain_count_mu`` (2048 detected, >= 99% ok) and
   ``RxEngine(mu_pos=u, mu_gid=2)`` on daemon-shaped blocks (every
   decoded MPDU is the one sent to that user in that PPDU); a wrong group
   id decodes nothing and a wrong-MCS config counts 0 ok; (g') the same
   PPDUs at an SNR where the syndrome gate sends rows to the Viterbi: K1
   and K2 launch on the MU path, and ``rx_chain_ok_mu`` on the card
   equals the CPU's on the first 64 packets;
10. streaming runtime and daemons (h): (h1) engine (b)'s 16-block stream
   written in 1<<16-sample chunks with backpressure into a native
   ``IqRing(1<<23)`` -> ``RxStreamer`` -> ``RxEngine`` -> ``PhyRxReporter``
   -> a MAC listener on its own thread: every sent packet decoded exactly
   once, one byte-equal [fmt, len, MPDU, mcs] datagram per MPDU and one
   channel report per NDP, ms/block from the first write to the last
   owned block beside engine (b)'s; (h2) the rx.grc/tx.grc loopback: 33
   MAC requests (L MCS0-7, HT MCS0-7, VHT MCS0-8, 100-1500 B) and an NDP
   -> ``PhyTxServer(device_tx=True)`` on the card -> ``TxStreamer`` ->
   cf32 UDP -> ``UdpIngest`` -> ``RxStreamer`` -> the listener, then
   VHT 1-SS and 2-SS bursts on two antennas: every MPDU back byte-equal,
   every ingest counting every sample sent and dropping none; (h3)
   ``tools_torch/cmu_demo.py --device cuda`` prints "closed loop:
   SUCCESS"; (h4) ``tools_torch/rx_daemon.py --file`` (the first 4
   blocks of (h1)'s stream) ``--once --device cuda`` counts every packet
   of those blocks ok.  K1/K2 must launch under the streamer;
11. scale-out (i), on 4 shards sharing the card (one a card where there
   are more): (i1) ``parallel.mesh.rx_chain_sp`` on the bench streams (4096
   detected at both SNRs, >= 99% ok at 32 dB, K1/K2 launch at 18 dB),
   timed beside the single-device chain; (i2) tests/test_mesh.py's
   streams through ``rx_chain_sp`` and ``frontend_sp`` on 8 shards, card
   == CPU; (i3) ``frontend_sp`` on the bench's packets without noise: one
   trigger per packet after dedup, each within [-64, 8] of its start;
   (i4) ``payload_decode_dp`` on 4096 windows cut from the 32 dB stream at
   the packet starts (>= 99% pass FCS, sampled PSDUs equal the bytes
   sent; the demodulation K8 and the scan Viterbi K6, once a shard each,
   and no other kernel) and 1024
   2x2 VHT 2-SS windows (all pass); (i5) ``mu_chain_dp`` on phase (g)'s
   2048 station-0 PPDUs cut into one capture a shard (32 dB: all
   detected, >= 99% ok; 12 dB:
   K1/K2 launch); (i6) ``tools_torch/mesh_worker.py`` as 2 processes over
   Gloo on the card, half the shards and half the input each: both print
   (i1)'s 18 dB counts and (i4)'s total; (i7) ``entry.entry`` and
   ``entry.dryrun_multichip``.  A ``{"mesh": ...}`` line holds the
   counts, the times and the shard layout;
12. the harness tools (j), each as a subprocess through its command line
   (four at a time on the card), outputs under build/chip_smoke_tools/:
   ``bench.py`` (its JSON line; >= 99% ok at 32 dB), ``perf_sweep.py``
   over VHT MCS0-8 and over L and HT MCS0-3, then one VHT 2-SS MCS and
   the MU sweep at MCS3 (n = 100, 0-30 dB in steps of 3: every point
   within 1/n of the JAX package's curve for the same command,
   tests/golden/per_sweep_jax.json;
   PER 0 at 30 dB; never rising by more than 2/n from one point to the
   next where the reference does not) and one small sweep on the card and
   on the CPU (per-row and per-slot results equal),
   ``bench_snr_sweep.py`` (every packet detected at every point, K1/K2
   launching at the lowest), ``bench_long.py`` (the ~32,300-step
   trellis: every packet detected, >= 99% ok), ``bench_tx.py`` (SU and
   MU, packet 0 within 2e-6 / 2e-5 of the gold model), ``bench_mu.py``
   (every packet ok), ``bench_daemon.py`` (a short ladder; the resident
   engine counts every packet ok), ``latency_report.py`` (one MCS, no
   packet lost) and ``multihost_scaling.py`` (1, 2 and 4 Gloo ranks,
   every packet decoded); a ``{"tools": ...}`` line holds their numbers
   and the kernels' launches and K1/K2's launch shapes summed from the
   ``launches`` / ``k1_k2_shapes`` each tool writes over its runs on the
   card;
13. K1/K2 held to their twins at every (B, T) they launched at in the
   engine runs (a)-(c), under the streamer ((h1), (h2)), in the
   sharded programs (i) and in the tools (j), and at bench_long's
   trellis (T = 32320) in any case: the shapes the buckets of the
   canonical configs, the batch ladder, the tiers and the shards give
   them, counted by ``ops/cuda_lib.launch`` (the kernels at each
   shape, the twins once per T on the shapes' rows stacked).

Kernel launches, their shapes and the decode tiers taken are the
program's ``utils/trace`` counters, read as the difference of two
snapshots around each run.

The line before the last is a JSON object describing each kernel; the
last is ``{"ok": true, "device": {...}}``.  Imports neither JAX nor the
JAX package (checked at both ends of the run).
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from tools_torch import timing

B = 4096
MCS = 7
SNR_HI, SNR_LO = 32.0, 18.0
CFO_HZ = 900.0
N_REP = 3


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


T_KERNEL = 4480                         # the chain's padded trellis
B_BUCKET = 64                           # one engine Viterbi bucket
KERNEL_REPS = 10

# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet): device
# memory 3.35 TB/s; 67 TFLOP/s float32 counts a fused multiply-add as two,
# so the adds, compares, selects and integer operations counted here
# (one lane-operation each) run at half of it.
PEAK_BYTES_S = 3.35e12
PEAK_LANE_OPS_S = 67e12 / 2


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 lane rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_LANE_OPS_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pad64(n_trellis: int) -> int:
    """The trellis length ``viterbi_decode`` hands K1: padded to 64s."""
    return -(-n_trellis // 64) * 64


def llr_pairs(torch, rng, dev, n_pkts=B, n_trellis=4420):
    """(n_pkts, pad64(n_trellis), 2) float32 LLR pairs on ``dev``: random,
    with punctured zeros (metric ties) and a zero-LLR tail past
    ``n_trellis`` (the chain's T = 4420 pads to T_KERNEL)."""
    x = rng.normal(size=(n_pkts, pad64(n_trellis), 2)).astype(np.float32) * 4.0
    x[:, 1::3, 1] = 0.0
    x[:, n_trellis:] = 0.0
    return torch.from_numpy(x).to(dev)


def hold_k1_k2(torch, VK, llrs, what):
    """K1 and K2 against their twins for pinned and uniform metrics,
    state-0 and argmax starts: exact equality.  ``llrs`` is one (B, T, 2)
    LLR tensor or a list of them of one T: the kernels run on each, the
    twins (row-independent loops over T) once on the rows stacked.
    Returns the max errors of K1's metrics and K2's bits."""
    if torch.is_tensor(llrs):
        llrs = [llrs]
    dev = llrs[0].device
    bs = [x.shape[0] for x in llrs]
    llr_all = torch.cat(llrs)
    err_acs = err_tb = 0.0
    for name in ("pinned", "uniform"):
        pm0s = [VK.state0_metrics(b, dev) if name == "pinned" else
                torch.zeros((b, 64), dtype=torch.float32, device=dev)
                for b in bs]
        got = [VK.acs_sweep(x, p) for x, p in zip(llrs, pm0s)]
        torch.cuda.synchronize()
        dec_ref, pm_ref = VK.acs_sweep_ref(llr_all, torch.cat(pm0s))
        dec = torch.cat([d for d, _ in got])
        pm = torch.cat([p for _, p in got])
        check(torch.equal(dec, dec_ref),
              f"K1 decisions differ from the twin ({what}, {name} pm0)")
        check(torch.equal(pm, pm_ref),
              f"K1 final metrics differ from the twin ({what}, {name} pm0)")
        err_acs = max(err_acs, float((pm - pm_ref).abs().max()))
        del dec_ref, pm_ref
        for sname in ("state 0", "argmax"):
            starts = [VK.state0_start(b, dev) if sname == "state 0" else
                      VK.argmax_start(p) for b, (_, p) in zip(bs, got)]
            bits = torch.cat([VK.traceback_sweep(d, st) for (d, _), st in
                              zip(got, starts)])
            torch.cuda.synchronize()
            bref = VK.traceback_ref(dec, torch.cat(starts))
            check(torch.equal(bits, bref),
                  f"K2 bits differ from the twin ({what}, {name} pm0, "
                  f"{sname})")
            err_tb = max(err_tb, float((bits.int() - bref.int()).abs().max()))
        log(f"kernels: K1/K2 == twins at {what} ({name} pm0)")
    return err_acs, err_tb


def phase_kernels(torch, VK):
    """K1/K2 vs their twins at the chain's shape and at one engine bucket
    shape; returns kernel records."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    llr = llr_pairs(torch, rng, dev)
    small = llr_pairs(torch, rng, dev, B_BUCKET)
    err_acs, err_tb = hold_k1_k2(torch, VK, llr, f"T={T_KERNEL} B={B}")
    e2 = hold_k1_k2(torch, VK, small, f"T={T_KERNEL} B={B_BUCKET}")
    err_acs, err_tb = max(err_acs, e2[0]), max(err_tb, e2[1])

    pinned = VK.state0_metrics(B, dev)
    start0 = VK.state0_start(B, dev)
    dec, pm = VK.acs_sweep(llr, pinned)
    bits = VK.traceback_sweep(dec, start0)
    ms_acs = cuda_ms(lambda: VK.acs_sweep(llr, pinned), 2 * KERNEL_REPS)
    ms_tb = cuda_ms(lambda: VK.traceback_sweep(dec, start0), 2 * KERNEL_REPS)
    plain_acs = cuda_ms(lambda: VK.acs_sweep_ref(llr, pinned), 1)
    plain_tb = cuda_ms(lambda: VK.traceback_ref(dec, start0), 1)
    dec_s, _ = VK.acs_sweep(small)
    small_acs = cuda_ms(lambda: VK.acs_sweep(small), KERNEL_REPS)
    small_tb = cuda_ms(lambda: VK.traceback_sweep(dec_s), KERNEL_REPS)
    log(f"kernels: acs_sweep {ms_acs:.3f} ms (twin {plain_acs:.1f} ms), "
        f"traceback_sweep {ms_tb:.3f} ms (twin {plain_tb:.1f} ms) at "
        f"T={T_KERNEL} B={B}; at B={B_BUCKET}: {small_acs:.3f} ms and "
        f"{small_tb:.3f} ms")
    steps = B * T_KERNEL
    return [
        {"name": "acs_sweep", "route": "cuda",
         "source": "gr_ieee80211_tpu_torch/csrc/viterbi.cu",
         "replaces": "gr_ieee80211_tpu/ops/viterbi_pallas.py:312",
         "max_abs_err": err_acs, "ms": ms_acs, "plain_ms": plain_acs,
         # 32 butterflies x (4 adds, 2 compares, 2 selects) a step
         **bound(nbytes(llr, pinned, dec, pm), 256 * steps),
         "library_ms": None, f"ms_at_B{B_BUCKET}": small_acs},
        {"name": "traceback_sweep", "route": "cuda",
         "source": "gr_ieee80211_tpu_torch/csrc/viterbi.cu",
         "replaces": "gr_ieee80211_tpu/ops/viterbi_pallas.py:394",
         "max_abs_err": err_tb, "ms": ms_tb, "plain_ms": plain_tb,
         # select, shift, mask, shift-or a step
         **bound(nbytes(dec, start0, bits), 4 * steps),
         "library_ms": None, f"ms_at_B{B_BUCKET}": small_tb},
    ]


def phase_chain(torch, VK, PRX, from_numpy_cf, bench):
    """The port's chain on the bench streams; returns launch counts."""
    cfg, mpdu, am, _, streams = bench
    dev = torch.device("cuda", 0)
    devs = {snr: from_numpy_cf(s[None], dev) for snr, s in streams.items()}
    log(f"chain: VHT mcs{MCS} 1ss, mpdu {len(mpdu)} B, nsym {cfg.nsym}, "
        f"T {cfg.n_trellis}, stream {devs[SNR_HI].shape[-1]} samples, "
        f"{B} packets")

    def run(snr):
        return PRX.rx_chain_count(cfg, devs[snr], mpdu_len=len(mpdu),
                                  max_pkts=B)

    # the main path: both operating points, the counters' change over each
    records, results, launches = {}, {}, {}
    for snr in (SNR_HI, SNR_LO):
        res, moved = timing.with_counters(lambda: run(snr), dev)
        results[snr] = tuple(int(x) for x in res)
        records[snr] = timing.decode_path(moved)
        counts = timing.kernel_launches(moved)["launches"]
        log(f"chain {snr:g} dB: (n_ok, n_det) = {results[snr]}, "
            f"path {records[snr]}, kernel launches {counts}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    log(f"chain: kernel launches in the main-path run: {launches}")

    n_ok, n_det = results[SNR_HI]
    check(n_det == B, f"32 dB: detected {n_det} of {B}")
    check(n_ok >= 0.99 * B, f"32 dB: only {n_ok} of {B} passed FCS")
    check(any(t == "full" or t.startswith("win") for t in records[SNR_LO]),
          f"18 dB did not run the full or windowed Viterbi: {records[SNR_LO]}")
    check(launches["acs_sweep"] > 0 and launches["traceback_sweep"] > 0,
          f"a kernel of the path was never launched: {launches}")

    # sampled PSDUs equal the transmitted A-MPDU bytes
    _, ltf_c, cfo, valid = PRX._detect_sync(cfg, devs[SNR_HI], B)
    rows = torch.arange(0, B, B // 16, device=dev)
    check(bool(valid[rows].all()), "sampled rows not all detected")
    out = PRX._payload_core(cfg, devs[SNR_HI], ltf_c[rows], cfo[rows],
                            mpdu_len=len(mpdu))
    psdu = out["psdu"][:, : len(am)].cpu().numpy()
    want = np.frombuffer(am, np.uint8)[None]
    check(bool((psdu == want).all()), "decoded PSDU bytes differ from sent")
    check(bool(out["mpdu_fcs_ok"].all()), "sampled rows fail FCS")
    log(f"chain: {len(rows)} sampled PSDUs equal the transmitted bytes")

    for snr in (SNR_HI, SNR_LO):
        run(snr)                        # warm the allocator for this path
        ms = cuda_ms(lambda: run(snr), N_REP)
        log(f"chain {snr:g} dB: {ms:.2f} ms/batch, {B / ms * 1e3:,.0f} pkt/s "
            f"(CUDA events, mean of {N_REP} batches of {B})")
    return launches, n_ok, results


def phase_reference(torch, PRX, from_numpy_cf, bench):
    """A small stream through the chain on the card and on the CPU."""
    from gr_ieee80211_tpu_torch.gold import channel
    cfg, mpdu, _, wave, _ = bench
    rng = np.random.default_rng(3)
    stream = channel.frame_stream(wave, 1.0, CFO_HZ, num=12, gap=400)
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    stream = channel.awgn(stream, rms / 10 ** (20 / 20), rng)
    outs = []
    for dev in ("cuda", "cpu"):
        x = from_numpy_cf(stream, dev)
        (ok, ltf, valid), moved = timing.with_counters(
            lambda: PRX.rx_chain_ok(cfg, x, mpdu_len=len(mpdu), max_pkts=16),
            torch.device(dev))
        outs.append((ok.cpu(), ltf.cpu(), valid.cpu(),
                     timing.decode_path(moved)))
    (ok_g, ltf_g, va_g, rec_g), (ok_c, ltf_c, va_c, rec_c) = outs
    check(torch.equal(va_g, va_c) and torch.equal(ltf_g, ltf_c),
          "card and CPU disagree on detection/timing")
    check(torch.equal(ok_g, ok_c), "card and CPU disagree on FCS flags")
    check(rec_g == rec_c, f"tier paths differ: {rec_g} vs {rec_c}")
    check(int(va_g.sum()) == 12, f"detected {int(va_g.sum())} of 12")
    log(f"reference: 12-packet 20 dB stream, card == CPU twins: "
        f"ok {int(ok_g.sum())}/12, path {rec_g}")


def hold_k4_k5(torch, VK, llr, what):
    """K4 and K5 on the batch-minor planes of ``llr`` against their twins
    and against K1/K2 on the same LLRs, for pinned and uniform metrics,
    state-0 and argmax starts: exact equality."""
    n = llr.shape[0]
    dev = llr.device
    l0 = llr[:, :, 0].T.contiguous()
    l1 = llr[:, :, 1].T.contiguous()
    pinned = VK.state0_metrics(n, dev).T.contiguous()
    uniform = torch.zeros((64, n), dtype=torch.float32, device=dev)
    err_acs = err_tb = 0.0
    for name, pm0 in (("pinned", pinned), ("uniform", uniform)):
        dec, pm = VK.acs_sweep(llr, pm0.T.contiguous())
        dl, dh = VK.planes_from_words(dec)
        pl, ph, ppm = VK.acs_sweep_packed(l0, l1, pm0)
        torch.cuda.synchronize()
        check(torch.equal(pl, VK.pack_planes(dl))
              and torch.equal(ph, VK.pack_planes(dh)),
              f"K4 planes differ from K1's packed ({what}, {name} pm0)")
        del dl, dh
        check(torch.equal(ppm, pm.T),
              f"K4 metrics differ from K1's ({what}, {name} pm0)")
        ref = VK.acs_sweep_packed_ref(l0, l1, pm0)
        check(all(torch.equal(a, b) for a, b in zip((pl, ph, ppm), ref)),
              f"K4 differs from its twin ({what}, {name} pm0)")
        err_acs = max(err_acs, float((ppm - ref[2]).abs().max()))
        del ref
        for sname, start in (("state 0", VK.state0_start(n, dev)),
                             ("argmax", VK.argmax_start(pm))):
            bits = VK.traceback_sweep_packed(pl, ph, start)
            torch.cuda.synchronize()
            check(torch.equal(bits, VK.traceback_sweep(dec, start).T),
                  f"K5 bits differ from K2's ({what}, {name} pm0, {sname})")
            bref = VK.traceback_packed_ref(pl, ph, start)
            check(torch.equal(bits, bref),
                  f"K5 bits differ from its twin ({what}, {name} pm0, "
                  f"{sname})")
            err_tb = max(err_tb, float((bits.int() - bref.int()).abs().max()))
        log(f"kernels: K4/K5 == twins == K1/K2 at {what} ({name} pm0)")
    return err_acs, err_tb


def phase_kernels_extra(torch, VK, FE):
    """K4/K5 vs their twins and K1/K2; K3 vs its twin; returns records."""
    rng = np.random.default_rng(9)
    dev = torch.device("cuda", 0)
    llr = llr_pairs(torch, rng, dev)
    small = llr_pairs(torch, rng, dev, B_BUCKET)
    err_acs, err_tb = hold_k4_k5(torch, VK, llr, f"T={T_KERNEL} B={B}")
    # K4/K5 run blocks of 8 packets up to B = 1024 and of 32 beyond:
    # ragged batches of both kinds, with rows moved as words (B % 4 == 0)
    # and byte by byte
    for x, what in ((small, f"T={T_KERNEL} B={B_BUCKET}"),
                    (llr[:100, :128].contiguous(), "T=128 B=100"),
                    (llr[:37, 4400:4464].contiguous(), "T=64 B=37"),
                    (llr[:1100, :128].contiguous(), "T=128 B=1100"),
                    (llr[:1037, 4400:4464].contiguous(), "T=64 B=1037")):
        e2 = hold_k4_k5(torch, VK, x, what)
        err_acs, err_tb = max(err_acs, e2[0]), max(err_tb, e2[1])

    l0 = llr[:, :, 0].T.contiguous()
    l1 = llr[:, :, 1].T.contiguous()
    pinned = VK.state0_metrics(B, dev).T.contiguous()
    start0 = VK.state0_start(B, dev)
    pl, ph, ppm = VK.acs_sweep_packed(l0, l1, pinned)
    bits = VK.traceback_sweep_packed(pl, ph, start0)
    ms_acs = cuda_ms(lambda: VK.acs_sweep_packed(l0, l1, pinned),
                     2 * KERNEL_REPS)
    ms_tb = cuda_ms(lambda: VK.traceback_sweep_packed(pl, ph, start0),
                    2 * KERNEL_REPS)
    plain_acs = cuda_ms(lambda: VK.acs_sweep_packed_ref(l0, l1, pinned), 1)
    plain_tb = cuda_ms(lambda: VK.traceback_packed_ref(pl, ph, start0), 1)
    s0 = small[:, :, 0].T.contiguous()
    s1 = small[:, :, 1].T.contiguous()
    sl, sh, _ = VK.acs_sweep_packed(s0, s1)
    small_acs = cuda_ms(lambda: VK.acs_sweep_packed(s0, s1), KERNEL_REPS)
    small_tb = cuda_ms(lambda: VK.traceback_sweep_packed(sl, sh), KERNEL_REPS)
    bound_k4 = bound(nbytes(l0, l1, pinned, pl, ph, ppm), 256 * B * T_KERNEL)
    bound_k5 = bound(nbytes(pl, ph, start0, bits), 4 * B * T_KERNEL)
    log(f"kernels: acs_sweep_packed {ms_acs:.3f} ms (twin {plain_acs:.1f} "
        f"ms), traceback_sweep_packed {ms_tb:.3f} ms (twin {plain_tb:.1f} "
        f"ms) at T={T_KERNEL} B={B}; at B={B_BUCKET}: {small_acs:.3f} ms and "
        f"{small_tb:.3f} ms")

    # K3: tolerance 1e-5 of the sample scale (the precise sincosf and
    # torch's sin/cos may differ in the last bits; phases reach ~630 rad)
    err_dr, times, bounds = 0.0, {}, {}
    for Bd, n in ((4096, 1984), (128, 100_000)):
        x = torch.randn((Bd, n), device=dev), torch.randn((Bd, n), device=dev)
        wins = FE.CF(*x)
        cfo = torch.from_numpy(rng.uniform(-2e4, 2e4, Bd).astype(np.float32)
                               ).to(dev)
        got = FE.derotate(wins, cfo, n)
        ref = FE.derotate_ref(wins, cfo, n)
        torch.cuda.synchronize()
        # a sample: the phase product, sincosf (~30), a complex product (6)
        bounds[(Bd, n)] = bound(nbytes(*x, cfo, got.re, got.im), 37 * Bd * n)
        err = max(float((got.re - ref.re).abs().max()),
                  float((got.im - ref.im).abs().max()))
        scale = float(torch.maximum(x[0].abs().max(), x[1].abs().max()))
        check(err <= 1e-5 * scale, f"K3 at ({Bd}, {n}): |err| {err:.3g} > "
              f"1e-5 x {scale:.3g}")
        err_dr = max(err_dr, err)
        times[(Bd, n)] = (cuda_ms(lambda: FE.derotate(wins, cfo, n),
                                  KERNEL_REPS),
                          cuda_ms(lambda: FE.derotate_ref(wins, cfo, n), 10),
                          cuda_ms(lambda: FE._derotate_factored(wins, cfo, n),
                                  10))
        log(f"kernels: derotate ({Bd}, {n}) max |err| {err:.3g} (scale "
            f"{scale:.3g}); {times[(Bd, n)][0]:.3f} ms, twin "
            f"{times[(Bd, n)][1]:.3f} ms, factored (the chain's) "
            f"{times[(Bd, n)][2]:.3f} ms")
    t_chain = times[(4096, 1984)]
    return [
        {"name": "derotate", "route": "cuda",
         "source": "gr_ieee80211_tpu_torch/csrc/derotate.cu",
         "replaces": "gr_ieee80211_tpu/ops/frontend.py:492",
         "max_abs_err": err_dr, "ms": t_chain[0], "plain_ms": t_chain[1],
         **bounds[(4096, 1984)], "library_ms": None,
         "factored_ms": t_chain[2],
         "ms_at_128x100000": times[(128, 100_000)][0],
         "plain_ms_at_128x100000": times[(128, 100_000)][1]},
        {"name": "acs_sweep_packed", "route": "cuda",
         "source": "gr_ieee80211_tpu_torch/csrc/viterbi.cu",
         "replaces": "gr_ieee80211_tpu/ops/viterbi_pallas.py:208",
         "max_abs_err": err_acs, "ms": ms_acs, "plain_ms": plain_acs,
         **bound_k4, "library_ms": None, f"ms_at_B{B_BUCKET}": small_acs},
        {"name": "traceback_sweep_packed", "route": "cuda",
         "source": "gr_ieee80211_tpu_torch/csrc/viterbi.cu",
         "replaces": "gr_ieee80211_tpu/ops/viterbi_pallas.py:275",
         "max_abs_err": err_tb, "ms": ms_tb, "plain_ms": plain_tb,
         **bound_k5, "library_ms": None, f"ms_at_B{B_BUCKET}": small_tb},
    ]


#: (B, T) of K6's holds and times: eight SIG-B rows (one VHT bucket of the
#: engine's batch ladder), the front end's stacked SIG call at the top of
#: the ladder, and the data-parallel payload windows' trellis
K6_SHAPES = ((8, 26), (3 * 192, 48), (1024, 4480))


def host_ms(torch, fn, reps: int) -> float:
    """Mean host milliseconds a call of ``fn()`` takes to issue, the card
    synchronized before and after the ``reps`` calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_scan_viterbi(torch, V):
    """K6 (the SIG decoder in one launch) against its twin at
    ``K6_SHAPES`` from state 0 and from the argmax, exact equality, with
    CUDA-event and host times of both; returns its record."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    times = {}
    for B_, T_ in K6_SHAPES:
        x = rng.normal(size=(B_, T_, 2)).astype(np.float32) * 2.0
        x[:, 1::3, 1] = 0.0                # punctured zeros: metric ties
        x[: B_ // 4] = np.round(x[: B_ // 4])
        x = torch.from_numpy(x).to(dev)
        for from_zero in (True, False):
            got = V.scan_viterbi(x, from_zero)
            ref = V.viterbi_decode_ref(x, from_zero)
            check(torch.equal(got, ref), f"K6 bits differ from the twin at "
                  f"(B, T) = ({B_}, {T_}), from_zero={from_zero}")
        reps = KERNEL_REPS if T_ < 1000 else 3
        times[(B_, T_)] = {
            "ms": cuda_ms(lambda: V.scan_viterbi(x), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: V.viterbi_decode_ref(x), 1),
            "host_ms": host_ms(torch, lambda: V.scan_viterbi(x), KERNEL_REPS),
            "plain_host_ms": host_ms(torch, lambda: V.viterbi_decode_ref(x),
                                     reps)}
        log(f"kernels: scan_viterbi == twin at (B, T) = ({B_}, {T_}); "
            + ", ".join(f"{k} {v:.3f}" for k, v in times[(B_, T_)].items()))
    B_, T_ = K6_SHAPES[-1]
    n_pad = -(-T_ // V.CHUNK) * V.CHUNK
    # LLR pairs in, bits out, the scratch decision words written and read;
    # a step: 64 states x (4 multiplies, 4 adds, a compare, a select)
    k6_bound = bound(B_ * (8 * T_ + T_ + 2 * 8 * n_pad), 640 * B_ * n_pad)
    return {"name": "scan_viterbi", "route": "cuda",
            "source": "gr_ieee80211_tpu_torch/csrc/scan_viterbi.cu",
            "replaces": None, "max_abs_err": 0.0,
            **times[(B_, T_)], **k6_bound, "library_ms": None,
            **{f"{k}_at_{b}x{t}": v for (b, t), tm in times.items()
               if (b, t) != (B_, T_) for k, v in tm.items()}}


#: K7's shapes (format, MCS, streams, antennas, rows): the daemon cells'
#: buckets (one or two rows of every branch; VHT one-stream with SIG-B),
#: then the chain's 4096 rows of the three heaviest branches
K7_SHAPES = (("L", 5, 1, 1, 1), ("HT", 3, 1, 1, 1), ("VHT", 4, 1, 1, 1),
             ("VHT", 4, 1, 1, 2), ("HT", 3, 1, 2, 1), ("HT", 11, 2, 2, 1),
             ("VHT", 5, 2, 2, 2), ("VHT", 4, 1, 1, 4096),
             ("VHT", 4, 1, 2, 4096), ("VHT", 5, 2, 2, 4096))


def phase_payload_chanest(torch, OF):
    """K7 (the payload channel estimate in one launch) against its twin at
    ``K7_SHAPES`` from windows of the tests' builder at 30 dB: the L and
    P-matrix estimates bit-equal, the refined one-stream ones within 1e-5
    of each row's largest |h|; CUDA-event and host times of both; returns
    its record (the largest refined gap among them)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import _chanest_windows as W
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
    from gr_ieee80211_tpu_torch.spec.params import Fmt
    dev = torch.device("cuda", 0)
    times, worst = {}, 0.0
    for k, (fname, mcs, nss, nrx, B_) in enumerate(K7_SHAPES):
        fmt = Fmt[fname]
        cfg, x, sigb_gi = W.windows(fmt, mcs, nss, nrx, B_, 30.0, 700 + k)
        xs = from_numpy_cf(x, dev)
        args = (xs, fmt, cfg.nltf, nss, sigb_gi)
        got = OF.payload_chanest(*args)
        ref = OF.payload_chanest_ref(*args)
        torch.cuda.synchronize()
        if fmt == Fmt.L or nss == 2:
            check(all(torch.equal(a, b) for a, b in zip(
                (*got[0], *got[1]), (*ref[0], *ref[1]))),
                f"K7 differs from the twin at {K7_SHAPES[k]}")
            gap = 0.0
        else:
            hmax = torch.sqrt(ref[0].re ** 2 + ref[0].im ** 2).reshape(
                B_, -1).amax(dim=1)
            gap = max(float((torch.maximum((a.re - b.re).abs(), (
                a.im - b.im).abs()).reshape(B_, -1).amax(dim=1) / hmax).max())
                for a, b in zip(got, ref))
            check(gap <= 1e-5, f"K7's refined estimate is {gap:.3g} of max "
                  f"|h| from the twin's at {K7_SHAPES[k]}")
        worst = max(worst, gap)
        tag = f"{fname}{nss}x{nrx}_b{B_}"
        times[tag] = {
            "ms": cuda_ms(lambda: OF.payload_chanest(*args), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: OF.payload_chanest_ref(*args), 3),
            "host_ms": host_ms(torch, lambda: OF.payload_chanest(*args),
                               KERNEL_REPS),
            "plain_host_ms": host_ms(
                torch, lambda: OF.payload_chanest_ref(*args), 3),
            "gap": gap}
        log(f"kernels: payload_chanest == twin at {tag}; "
            + ", ".join(f"{k2} {v:.4g}" for k2, v in times[tag].items()))
    # the chain's one-stream VHT shape with SIG-B on one antenna: 7 windows
    # of 64 samples read, 64 + 4 estimates written (complex float32); 7
    # DFTs of 64 x 64 products in float64 multiply-adds (two lane-
    # operations each: the float64 rate is half the float32 one), the
    # 56 x 56 complex projection and ~200 other float operations a tone
    tag = "VHT1x1_b4096"
    B_ = 4096
    k7_bound = bound(B_ * (7 * 64 * 8 + 68 * 8),
                     B_ * 64 * (2 * 7 * 64 * 4 + 2 * 56 * 4 + 200))
    return {"name": "payload_chanest", "route": "cuda",
            "source": "gr_ieee80211_tpu_torch/csrc/payload_chanest.cu",
            "replaces": None, "max_abs_err": worst,
            **{k2: v for k2, v in times[tag].items() if k2 != "gap"},
            **k7_bound, "library_ms": None,
            **{f"{k2}_at_{t}": v for t, tm in times.items() if t != tag
               for k2, v in tm.items()}}


#: K8's shapes (format, MCS, streams, antennas, rows, symbols: None = the
#: packets' own): the daemon cells' buckets (one or two rows of every
#: equalizer branch), then the chain's 4096 rows: bench.py's VHT MCS7
#: bucket (17 symbols) on one antenna (SISO) and two (MRC), and two streams
K8_SHAPES = (("L", 5, 1, 1, 1, None), ("HT", 3, 1, 1, 1, None),
             ("VHT", 4, 1, 1, 2, None), ("HT", 3, 1, 2, 1, None),
             ("HT", 11, 2, 2, 1, None), ("VHT", 5, 2, 2, 2, None),
             ("VHT", 7, 1, 1, 4096, 17), ("VHT", 7, 1, 2, 4096, 17),
             ("VHT", 4, 2, 2, 4096, 17))


def phase_payload_demod(torch, OF):
    """K8 (the payload demodulation in one launch) against its twin at
    ``K8_SHAPES`` from the tests' windows at 25 dB and the twin's channel
    estimate: every LLR within 1e-5 times the row's channel condition
    number of its row's largest |LLR| (a phasor rounding, should PyTorch
    sum the pilots in another order than K8's), the share of symbols
    bit-equal; CUDA-event and host times of both; returns its record,
    timed at the chain's one-antenna shape, and the other shapes' times
    beside."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import _chanest_windows as W
    from gr_ieee80211_tpu_torch.spec.params import Fmt
    dev = torch.device("cuda", 0)
    times, worst = {}, 0.0
    for k, (fname, mcs, nss, nrx, B_, nsym) in enumerate(K8_SHAPES):
        cfg, xs, ds, h, ph = W.demod_case((Fmt[fname], mcs, nss), nrx, B_,
                                          nsym, 800 + k, dev)
        args = (xs, ds, h, ph, cfg)
        got = OF.payload_demod(*args)
        ref = OF.payload_demod_ref(*args)
        torch.cuda.synchronize()
        rel = ((got - ref).abs().amax(dim=1)
               / ref.abs().amax(dim=1)).double()
        gap = float(rel.max())
        kappa = W.row_condition(h, cfg.fmt == Fmt.L)
        check(bool((rel <= 1e-5 * kappa).all()), f"K8's LLRs are {gap:.3g} "
              f"of max |LLR| from the twin's at {K8_SHAPES[k]}")
        worst = max(worst, gap)
        same = float((got == ref).reshape(B_, cfg.nsym, -1).all(dim=2)
                     .float().mean())
        tag = f"{fname}{nss}x{nrx}_b{B_}_n{cfg.nsym}"
        times[tag] = {
            "ms": cuda_ms(lambda: OF.payload_demod(*args), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: OF.payload_demod_ref(*args), 3),
            "host_ms": host_ms(torch, lambda: OF.payload_demod(*args),
                               KERNEL_REPS),
            "plain_host_ms": host_ms(
                torch, lambda: OF.payload_demod_ref(*args), 3),
            "gap": gap, "symbols_bit_equal": same}
        log(f"kernels: payload_demod == twin at {tag}; "
            + ", ".join(f"{k2} {v:.4g}" for k2, v in times[tag].items()))
    # the chain's shape, (B, nrx, nsym) = (4096, 1, 17), VHT MCS7: the 64
    # samples of each symbol's window read, the estimate (64 + 4 complex)
    # and 17 x 312 LLRs written; a window's DFT is 64 x 64 x 4 float64
    # multiply-adds (two lane-operations each: the float64 rate is half the
    # float32 one); the equalizer and demap ~100 float operations a tone
    tag = "VHT1x1_b4096_n17"
    B_, nsym = 4096, 17
    k8_bound = bound(B_ * (nsym * 64 * 8 + 68 * 8 + nsym * 312 * 4),
                     B_ * nsym * 64 * (2 * 64 * 4 + 100))
    return {"name": "payload_demod", "route": "cuda",
            "source": "gr_ieee80211_tpu_torch/csrc/payload_demod.cu",
            "replaces": None, "max_abs_err": worst,
            **{k2: v for k2, v in times[tag].items()
               if k2 not in ("gap", "symbols_bit_equal")},
            **k8_bound, "library_ms": None,
            **{f"{k2}_at_{t}": v for t, tm in times.items() if t != tag
               for k2, v in tm.items()}}


# ---------------------------------------------------------------------------
# engine phases
# ---------------------------------------------------------------------------

ADDR = ("02:00:00:00:00:01", "02:00:00:00:00:02", "02:00:00:00:00:01")
BLOCK, HALO, LCTX = 1 << 19, 16384, 256   # the rx_daemon defaults
N_BLOCKS = 16


def make_packet(rng, fmt, mcs, nss=1, n_bytes=300, n_mpdus=1):
    """(waveform (nss, n) at unit rms, expected result fields)."""
    from gr_ieee80211_tpu_torch.gold import mac, tx
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    if n_bytes == 0:
        # a 2-stream VHT NDP (a 1-stream NDP's L-SIG length fails the
        # receiver's plausibility bound), seen through a fixed 1x2 channel
        cfg = PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True)
        wave = np.array([[0.8, 0.6j]]) @ tx.tx_waveform(
            cfg, b"", group_id=0, partial_aid=0)
        return wave / np.sqrt(np.mean(np.abs(wave) ** 2)), dict(
            fmt=Fmt.VHT, mcs=0, nss=2, mpdus=[], is_ndp=True)
    sizes = [n_bytes // n_mpdus] * n_mpdus
    mpdus = [mac.qos_data_frame(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                                *ADDR, k) for k, n in enumerate(sizes)]
    if fmt == Fmt.VHT:
        psdu = mac.ampdu_aggregate_vht(mpdus)
        cfg = PhyConfig(fmt, mcs, nss, len(psdu), ampdu=True)
        wave = tx.tx_waveform(cfg, psdu, group_id=0, partial_aid=0)
    elif n_mpdus > 1:
        psdu = mac.ampdu_aggregate_ht(mpdus)
        cfg = PhyConfig(fmt, mcs, nss, len(psdu), ampdu=True)
        wave = tx.tx_waveform(cfg, psdu)
    else:
        cfg = PhyConfig(fmt, mcs, nss, len(mpdus[0]))
        wave = tx.tx_waveform(cfg, mpdus[0])
    return wave / np.sqrt(np.mean(np.abs(wave) ** 2)), dict(
        fmt=fmt, mcs=mcs, nss=nss, mpdus=mpdus, is_ndp=False)


def random_packet(rng):
    """One packet of the mixed daemon traffic: L MCS0-7, HT MCS0-7 or VHT
    MCS0-8, 100-1500 B, some 2-3 MPDU A-MPDUs, a few (2-stream) NDPs."""
    from gr_ieee80211_tpu_torch.spec.params import Fmt
    u = rng.random()
    if u < 0.03:
        return make_packet(rng, Fmt.VHT, 0, n_bytes=0)
    fmt = (Fmt.L, Fmt.HT, Fmt.VHT)[int(rng.integers(0, 3))]
    mcs = int(rng.integers(0, 9 if fmt == Fmt.VHT else 8))
    n_mpdus = int(rng.integers(2, 4)) if fmt != Fmt.L and u > 0.8 else 1
    return make_packet(rng, fmt, mcs, n_bytes=int(rng.integers(100, 1501)),
                       n_mpdus=n_mpdus)


def daemon_stream(rng, snr_db=30.0):
    """(stream (N_BLOCKS*BLOCK + HALO,), sent [(start, fields)]).  Blocks
    4-7 carry only VHT MCS7 400 B and blocks 12-15 only HT MCS5 300 B
    (homogeneous traffic arms the speculation); the rest is mixed.  Every
    packet starts inside a block's own span and ends inside its halo."""
    from gr_ieee80211_tpu_torch.spec.params import Fmt
    homog = {4: make_packet(rng, Fmt.VHT, 7, n_bytes=400),
             12: make_packet(rng, Fmt.HT, 5, n_bytes=300)}
    x = np.zeros(N_BLOCKS * BLOCK + HALO, np.complex64)
    sent, pos = [], 0
    for k in range(N_BLOCKS):
        end_own = (k + 1) * BLOCK
        fixed = homog.get(k - k % 4) if k % 8 >= 4 else None
        while True:
            wave, fields = fixed if fixed is not None else random_packet(rng)
            start = pos + int(rng.integers(300, 3000))
            n = wave.shape[-1]
            if start >= end_own - 1000 or start + n > end_own + HALO - 2000:
                pos = max(pos, end_own)
                break
            x[start: start + n] = wave[0]
            sent.append((start, fields))
            pos = start + n
    noise = (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
             ) * (10 ** (-snr_db / 20) / np.sqrt(2))
    return (x + noise.astype(np.complex64)), sent


def run_blocks(eng, stream, n_blocks=N_BLOCKS):
    """Feed the first ``n_blocks`` blocks of the stream as rx_daemon blocks
    (256 samples of left context, BLOCK owned samples, HALO look-ahead)
    through begin/finish_process with the streamer's trigger-ownership
    rule; returns (owned results with absolute start/trig, block kinds,
    seconds per block)."""
    import torch
    out, kinds, secs = [], [], []
    lctx = np.zeros(LCTX, np.complex64)
    for k in range(n_blocks):
        t0 = k * BLOCK
        block = stream[t0: t0 + BLOCK + HALO]
        view = np.concatenate([lctx, block])[None]
        lctx = block[BLOCK - LCTX: BLOCK]
        lo = 0 if k == 0 else LCTX
        tic = time.perf_counter()
        handle = eng.begin_process(view)
        res = eng.finish_process(handle)
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - tic)
        kinds.append(handle[2][0])
        for r in res:
            if lo <= r.trig < LCTX + BLOCK:
                r.start += t0 - LCTX
                r.trig += t0 - LCTX
                out.append(r)
    return out, kinds, secs


def check_sent(results, sent, what):
    """Every sent packet decoded exactly once with its fields."""
    starts = np.array([s for s, _ in sent])
    hits = [0] * len(sent)
    for r in results:
        j = int(np.argmin(np.abs(starts - r.trig)))
        check(abs(int(starts[j]) - r.trig) < 400,
              f"{what}: result at trig {r.trig} matches no sent packet")
        hits[j] += 1
        f = sent[j][1]
        check(r.ok and (r.fmt, r.mcs, r.nss, r.is_ndp) == (
            f["fmt"], f["mcs"], f["nss"], f["is_ndp"]) and (
                r.is_ndp or r.mpdus == f["mpdus"]),
              f"{what}: packet at {starts[j]} decoded as ok={r.ok} "
              f"{r.fmt} mcs{r.mcs} nss{r.nss} ndp={r.is_ndp}, sent {f}")
    missed = [int(starts[j]) for j, h in enumerate(hits) if h != 1]
    check(not missed, f"{what}: {len(missed)} packets not decoded exactly "
          f"once, first at {missed[:5]}")


def phase_engine(torch, PRX, bench, chain_ok):
    """The general engine at full size; returns per-kernel launch counts
    summed over its runs (the counters' change over each), the timing of
    (b) and K1/K2's launch shapes."""
    from gr_ieee80211_tpu_torch.spec.params import Fmt
    launches, shapes = {}, set()

    def tally(fn, what):
        out, counts = counted_run(torch, fn, f"engine {what}", shapes)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return out

    # (a) the bench's 32 dB stream
    cfg, mpdu, _, _, streams = bench
    tic = time.perf_counter()
    res = tally(lambda: PRX.RxEngine(nrx=1).process(streams[SNR_HI]),
                "(a)")
    secs = time.perf_counter() - tic
    n_ok = sum(r.ok for r in res)
    check(len(res) == B and all(r.fmt == Fmt.VHT and r.mcs == MCS
                                for r in res),
          f"engine (a): {len(res)} packets of {B} detected and classified")
    check(n_ok >= 0.99 * B, f"engine (a): only {n_ok} of {B} ok")
    check(all(r.mpdus[0] == mpdu for r in res if r.ok),
          "engine (a): an ok packet's MPDU differs from the sent one")
    log(f"engine (a): 32 dB bench stream, {len(res)}/{B} detected, {n_ok} ok "
        f"(rx_chain_count: {chain_ok} ok), {secs:.2f} s host clock")

    # (b) daemon-shaped traffic
    rng = np.random.default_rng(23)
    stream, sent = daemon_stream(rng)
    log(f"engine (b): {len(sent)} packets in {N_BLOCKS} blocks of {BLOCK} + "
        f"{HALO} halo, 30 dB")
    timing = {True: [], False: []}
    # the first pass warms the allocator and the per-config constants and
    # is not timed; then bucket-only and speculative passes alternate
    for i, spec in enumerate((False, False, True, True, False)):
        eng = PRX.RxEngine(nrx=1, speculate=spec)
        got, kinds, secs = tally(lambda: run_blocks(eng, stream),
                                 f"(b) pass {i} speculate={spec}")
        check_sent(got, sent, f"engine (b) speculate={spec}")
        if i == 0:
            log(f"engine (b) warm-up pass: {1e3 * sum(secs) / N_BLOCKS:.1f} "
                "ms/block")
            continue
        timing[spec].append(sum(secs))
        n_spec = kinds.count("spec")
        ms = 1e3 * sum(secs) / N_BLOCKS
        log(f"engine (b) speculate={spec}: {len(got)} packets, "
            f"{n_spec} speculative blocks, {ms:.1f} ms/block, "
            f"{len(got) / sum(secs):,.0f} pkt/s, "
            f"{N_BLOCKS * BLOCK / sum(secs) / 1e6:.2f} Msamples/s")
        if spec:
            check(n_spec >= 4, f"engine (b): only {n_spec} speculative blocks")

    # (c) 2 antennas: HT MCS8-15 and VHT 2 SS through a 2x2 channel
    from gr_ieee80211_tpu_torch.gold import channel
    rng = np.random.default_rng(29)
    parts, sent2, pos = [], [], 400
    for i in range(24):
        fmt = Fmt.HT if i % 2 == 0 else Fmt.VHT
        mcs = 8 + (i // 2) % 8 if fmt == Fmt.HT else (i // 2) % 9
        wave, fields = make_packet(rng, fmt, mcs, nss=2,
                                   n_bytes=int(rng.integers(100, 1501)))
        h = np.eye(2) + 0.3 * (rng.normal(size=(2, 2))
                               + 1j * rng.normal(size=(2, 2)))
        parts += [np.zeros((2, 400), complex), channel.mimo_channel(wave, h)]
        sent2.append((pos, fields))
        pos += 400 + wave.shape[-1]
    x2 = np.concatenate(parts + [np.zeros((2, 400), complex)], axis=1)
    x2 = channel.awgn(x2, 10 ** (-35 / 20), rng).astype(np.complex64)
    res2 = tally(lambda: PRX.RxEngine(nrx=2).process(x2), "(c)")
    check_sent(res2, sent2, "engine (c) 2x2")
    log(f"engine (c): {len(res2)}/24 HT MCS8-15 / VHT 2-SS packets decoded "
        "on 2 antennas")
    log(f"engine: kernel launches in the engine runs: {launches}")
    check(launches["acs_sweep"] > 0 and launches["traceback_sweep"] > 0,
          f"the engine runs never launched K1/K2: {launches}")
    return launches, timing, shapes


def phase_engine_reference(torch, PRX):
    """(d) a small mixed stream through the engine on the card and on the
    CPU (the kernels' twins): the same per-packet results.  LTF timing
    may move by <= 2 samples at a near-tie of the flat autocorrelation
    top (sums taken in another order), then the bytes must still agree."""
    from gr_ieee80211_tpu_torch.gold import channel
    from gr_ieee80211_tpu_torch.spec.params import Fmt
    rng = np.random.default_rng(31)
    specs = [(Fmt.L, 3, 1, 400, 1), (Fmt.HT, 5, 1, 700, 1),
             (Fmt.VHT, 4, 1, 500, 1), (Fmt.HT, 2, 1, 900, 3),
             (Fmt.VHT, 6, 1, 1200, 2), (Fmt.VHT, 0, 1, 0, 1),
             (Fmt.L, 6, 1, 200, 1), (Fmt.VHT, 8, 1, 300, 1)]
    parts = []
    for fmt, mcs, nss, nb, nm in specs:
        wave, _ = make_packet(rng, fmt, mcs, nss, nb, nm)
        parts += [np.zeros(700, complex), channel.apply_cfo(wave[0], 700.0)]
    x = channel.awgn(np.concatenate(parts + [np.zeros(700)]),
                     10 ** (-26 / 20), rng).astype(np.complex64)
    got = {d: PRX.RxEngine(nrx=1, device=d).process(x)
           for d in ("cuda", "cpu")}
    g, c = got["cuda"], got["cpu"]
    check(len(g) == len(c) == len(specs),
          f"engine (d): {len(g)} results on the card, {len(c)} on the CPU")
    for a, b in zip(g, c):
        for f in ("ok", "fmt", "mcs", "nss", "trig", "psdu", "mpdus",
                  "is_ndp"):
            check(getattr(a, f) == getattr(b, f),
                  f"engine (d): card and CPU differ in {f}")
        check(abs(a.start - b.start) <= 2, "engine (d): timing differs")
    log(f"engine (d): {len(g)}-packet mixed stream, card == CPU per packet "
        f"({sum(r.ok for r in g)} ok)")


# ---------------------------------------------------------------------------
# transmit and MU-MIMO sounding loop phases
# ---------------------------------------------------------------------------

B_MU = 2048
GAP = 240                               # the bench's gap between packets
SNR_MU_LO = 12.0                        # (g'): MCS3 rows leave the fast path
CFO_MU_HZ = 300.0
TOL_TX_SU, TOL_TX_MU = 2e-6, 2e-5       # vs the gold model (float32 IDFT sums)
STA_ADDR = ("02:00:00:00:00:10", "02:00:00:00:00:11")
AP_ADDR = "02:00:00:00:00:01"


def random_ampdus(rng, n_pkts, n_payload, sta=0):
    """``n_pkts`` single-MPDU VHT A-MPDUs with different random payloads:
    (MPDUs, A-MPDUs, (n_pkts, len) uint8 array of the A-MPDU bytes)."""
    from gr_ieee80211_tpu_torch.gold import mac
    mpdus = [mac.qos_data_frame(
        bytes(rng.integers(0, 256, n_payload, dtype=np.uint8)),
        STA_ADDR[sta], AP_ADDR, STA_ADDR[sta], k % 4096)
        for k in range(n_pkts)]
    ams = [mac.ampdu_aggregate_vht([m]) for m in mpdus]
    return mpdus, ams, np.stack([np.frombuffer(a, np.uint8) for a in ams])


def lay_stream(torch, CF, waves, cfo_hz):
    """(B, n) CF waveforms on the card -> ((N,) CF stream with each packet
    rotated by ``cfo_hz`` from its own first sample and GAP samples
    between packets, 1024 before the first; the packets' rms; spacing)."""
    B, n = waves.shape
    dev = waves.device
    ph = (2 * np.pi * cfo_hz / 20e6) * torch.arange(n, dtype=torch.float64,
                                                    device=dev)
    w = waves * CF(torch.cos(ph).float(), torch.sin(ph).float())

    def lay(v):
        out = torch.zeros((B, n + GAP), dtype=torch.float32, device=dev)
        out[:, :n] = v
        return torch.nn.functional.pad(out.reshape(-1), (1024, 1024))
    rms = float(torch.sqrt(waves.abs2().mean()))
    return CF(lay(w.re), lay(w.im)), rms, n + GAP


def add_noise(torch, CF, base, rms, snr_db, gen):
    """AWGN at ``snr_db`` below the packets' rms, from ``gen``; returns the
    (1, N) stream the chains take."""
    sigma = rms / 10 ** (snr_db / 20) / np.sqrt(2)
    n = base.shape[-1]
    nz = torch.randn((2, n), generator=gen, device=base.device) * sigma
    return CF((base.re + nz[0])[None], (base.im + nz[1])[None])


def counted_run(torch, fn, what, shapes=None):
    """``fn()`` and each kernel's launches over it (the change of the
    program's counters): (result, counts).  K1/K2's launch shapes (B, T)
    go into the set ``shapes`` when one is given."""
    out, moved = timing.with_counters(fn, torch.device("cuda", 0))
    kern = timing.kernel_launches(moved)
    log(f"{what}: kernel launches {kern['launches']}, decode path "
        f"{timing.decode_path(moved)}")
    if shapes is not None:
        shapes |= {tuple(bt) for bt in kern["k1_k2_shapes"]}
    return out, kern["launches"]


def timed(torch, fn, what, n_items, unit, smi):
    fn()                                # warm the allocator and the caches
    ms = cuda_ms(fn, N_REP)
    log(f"{what}: {ms:.2f} ms/batch, {n_items / ms * 1e3:,.0f} {unit}/s (CUDA "
        f"events, warmed, mean of {N_REP}; {smi})")
    return ms


def phase_tx_su(torch, PRX, PTX, CF, bench, smi):
    """(e) the port's transmitter feeds the port's chain at full width."""
    from gr_ieee80211_tpu_torch.gold import tx as gtx
    cfg = bench[0]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(41)
    mpdus, ams, arr = random_ampdus(rng, B, 500)
    check(arr.shape == (B, cfg.length), f"(e) A-MPDUs of {arr.shape[1]} B")
    seeds = (np.arange(B) % 127 + 1).astype(np.int64)
    arr_d, seeds_d = torch.from_numpy(arr).to(dev), torch.from_numpy(seeds).to(dev)
    waves = PTX.tx_batch(cfg, arr_d, seeds_d)
    check(waves.shape == (B, 1, cfg.n_samples)
          and bool(torch.isfinite(waves.re).all() & torch.isfinite(waves.im).all()),
          f"(e) tx_batch gave {tuple(waves.shape)}")
    eng = PTX.TxEngine().tx(cfg, ams[:8], seeds=seeds[:8])
    err = 0.0
    for i in range(8):
        gold = gtx.tx_waveform(cfg, ams[i], seed=int(seeds[i]), group_id=0,
                               partial_aid=0)
        got = waves.re[i].cpu().numpy() + 1j * waves.im[i].cpu().numpy()
        err = max(err, float(np.abs(got - gold).max()),
                  float(np.abs(eng[i] - gold).max()))
    check(err < TOL_TX_SU, f"(e) tx_batch vs gold: max |err| {err:.3g}")
    log(f"tx (e): tx_batch and TxEngine.tx of {B} VHT mcs{MCS} packets, 8 held "
        f"to the gold model: max |err| {err:.3g} (< {TOL_TX_SU:g})")

    base, rms, spacing = lay_stream(torch, CF, waves[:, 0], CFO_HZ)
    gen = torch.Generator(device=dev).manual_seed(43)
    stream = add_noise(torch, CF, base, rms, SNR_HI, gen)
    ml = len(mpdus[0])
    (n_ok, n_det), counts = counted_run(
        torch, lambda: tuple(int(x) for x in PRX.rx_chain_count(
            cfg, stream, mpdu_len=ml, max_pkts=B)), "tx (e) chain")
    check(n_det == B, f"(e) detected {n_det} of {B}")
    check(n_ok >= 0.99 * B, f"(e) only {n_ok} of {B} passed FCS")
    ok, ltf, valid = PRX.rx_chain_ok(cfg, stream, mpdu_len=ml, max_pkts=B)
    check(int(ok.sum()) == n_ok and bool(valid.all()),
          "(e) rx_chain_ok disagrees with rx_chain_count")
    sent_at = 1024 + spacing * torch.arange(B, device=dev)
    check(bool(((ltf - sent_at - 192).abs() < 32).all()),
          "(e) a packet was not found where it was laid")
    _, ltf_c, cfo, _ = PRX._detect_sync(cfg, stream, B)
    rows = torch.arange(5, B, B // 64, device=dev)
    out = PRX._payload_core(cfg, stream, ltf_c[rows], cfo[rows], mpdu_len=ml)
    check(bool((out["psdu"][:, : cfg.length] == arr_d[rows]).all()),
          "(e) decoded PSDU bytes differ from the bytes sent")
    log(f"tx (e): own transmitter -> chain at {SNR_HI:g} dB: {n_det}/{B} "
        f"detected, {n_ok} ok, {len(rows)} sampled PSDUs equal "
        "the bytes sent")
    ms = timed(torch, lambda: PTX.tx_batch(cfg, arr_d, seeds_d),
               f"tx_batch B={B} VHT mcs{MCS} 530 B MPDU", B, "pkt", smi)
    return counts, {"tx_batch_ms": ms, "tx_su_max_abs_err": err,
                    "tx_su_n_ok": n_ok}


def phase_tx_mu(torch, PTX, from_numpy_cf, smi):
    """(f) the two-user MU transmit at full width against the gold model."""
    from gr_ieee80211_tpu_torch.gold import tx as gtx
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig, mu_config
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(47)
    _, ams0, arr0 = random_ampdus(rng, B_MU, 500, 0)
    _, ams1, arr1 = random_ampdus(rng, B_MU, 300, 1)
    mu = mu_config([PhyConfig(Fmt.VHT, 7, 1, arr0.shape[1], ampdu=True),
                    PhyConfig(Fmt.VHT, 7, 1, arr1.shape[1], ampdu=True)],
                   group_id=2)
    q = (rng.normal(size=(64, 2, 2)) + 1j * rng.normal(size=(64, 2, 2))
         ) / np.sqrt(2)
    seeds = (np.arange(B_MU) % 127 + 1).astype(np.int64)
    waves = PTX.TxEngine().tx_mu(mu, [ams0, ams1], q, seeds=seeds)
    check(waves.shape == (B_MU, 2, mu.n_samples) and np.isfinite(waves).all(),
          f"(f) tx_mu gave {waves.shape}")
    err = 0.0
    for i in (0, 1, B_MU // 2, B_MU - 1):
        gold = gtx.tx_waveform_mu(mu, [ams0[i], ams1[i]], q,
                                  seed=int(seeds[i]))
        err = max(err, float(np.abs(waves[i] - gold).max()))
    check(err < TOL_TX_MU, f"(f) tx_mu vs gold: max |err| {err:.3g}")
    log(f"tx (f): TxEngine.tx_mu of {B_MU} two-user VHT mcs7 PPDUs (seeded "
        f"random Q), 4 held to the gold model: max |err| {err:.3g} "
        f"(< {TOL_TX_MU:g})")
    pays = (torch.from_numpy(arr0).to(dev), torch.from_numpy(arr1).to(dev))
    seeds_d, q_d = torch.from_numpy(seeds).to(dev), from_numpy_cf(q, dev)
    ms = timed(torch, lambda: PTX.tx_batch_mu(mu, pays, seeds_d, q_d),
               f"tx_batch_mu B={B_MU} 2 users VHT mcs7", B_MU, "PPDU", smi)
    return {"tx_batch_mu_ms": ms, "tx_mu_max_abs_err": err}


def check_mu_results(results, sent, spacing, what):
    """Every ok result carries exactly the MPDU sent in the PPDU at its
    trigger; returns the number of distinct PPDUs decoded."""
    seen = set()
    for r in results:
        if not r.ok:
            continue
        i = int(round((r.trig - 1024) / spacing))
        check(0 <= i < len(sent) and abs(r.trig - 1024 - i * spacing) < 400,
              f"{what}: a result at trig {r.trig} matches no PPDU")
        check(r.mpdus == [sent[i]],
              f"{what}: PPDU {i} decoded to another MPDU than the one sent")
        check(i not in seen, f"{what}: PPDU {i} decoded twice")
        seen.add(i)
    return len(seen)


def mu_sounding(PRX, txe, rng):
    """Phase (g)'s sounding: two seeded 1x2 station channels; the NDP
    through ``txe.tx`` -> each channel -> each station's
    ``RxEngine(nrx=1).process`` -> feedback rows -> the zero-forcing Q.
    Returns (the channels, Q (56, 2, 2))."""
    from gr_ieee80211_tpu_torch.gold import channel, sounding
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
             / np.sqrt(2) for _ in range(2)]
    ndp = txe.tx(PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True), [b""])[0]
    fb = []
    for u in range(2):
        s = channel.frame_stream(channel.mimo_channel(ndp, h_sta[u]), 1.0,
                                 200.0 + 100 * u, gap=1200)
        s = channel.awgn(s, 0.015 / 10 ** (35 / 20), rng)
        res = PRX.RxEngine(nrx=1).process(s.astype(np.complex64))
        check(len(res) == 1 and res[0].is_ndp and res[0].nss == 2
              and res[0].ndp_chan.shape == (1, 2, 64),
              f"(g) station {u} did not find the NDP")
        fb.append(sounding.feedback_from_ndp(res[0].ndp_chan)[0])
    return h_sta, sounding.zf_q(np.stack(fb))


def mu_traffic(rng):
    """Phase (g)'s PPDUs: B_MU two-user PPDUs, user 0 VHT MCS3 (120 B
    payload), user 1 MCS2 (84 B), payloads varied.  Returns (the
    MuConfig, per user: MPDUs sent, A-MPDUs, (B_MU, len) uint8 arrays; the
    scrambler seeds)."""
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig, mu_config
    sent, ams, arrs = zip(*(random_ampdus(rng, B_MU, n, u)
                            for u, n in enumerate((120, 84))))
    mu = mu_config([PhyConfig(Fmt.VHT, 3, 1, arrs[0].shape[1], ampdu=True),
                    PhyConfig(Fmt.VHT, 2, 1, arrs[1].shape[1], ampdu=True)],
                   group_id=2)
    seeds = (np.arange(B_MU) % 127 + 1).astype(np.int64)
    return mu, sent, ams, arrs, seeds


def mu_user_cfg(mu, u):
    """The config station ``u`` decodes its own stream of ``mu`` with."""
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    uc = mu.users[u]
    return PhyConfig(Fmt.VHT, uc.mcs, 1, uc.psdu_len, ampdu=True,
                     mu_nsym=mu.nsym)


def mu_heard(torch, CF, waves, h):
    """(B, 2, n) transmit waveforms through the 1x2 channel row ``h``:
    what the station's one antenna hears, (B, n)."""
    dev = waves.re.device
    taps = [CF(torch.tensor(float(v.real), device=dev),
               torch.tensor(float(v.imag), device=dev)) for v in h]
    return waves[:, 0] * taps[0] + waves[:, 1] * taps[1]


def phase_mu_loop(torch, VK, PRX, PTX, CF, from_numpy_cf, smi):
    """(g), (g'): NDP sounding -> ZF Q -> precoded MU PPDUs -> each
    station's decode, through the entry points, on the card.  K1/K2 are
    held to their twins at the shape each user's decode gives them."""
    from gr_ieee80211_tpu_torch.gold import sounding
    from gr_ieee80211_tpu_torch.ops.cplx import to_numpy
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(53)
    txe = PTX.TxEngine()

    # sounding: NDP -> each station's channel estimate -> feedback -> ZF Q
    h_sta, q56 = mu_sounding(PRX, txe, rng)
    hq = np.einsum("utk,ktj->kuj", np.stack([np.repeat(
        h[0][:, None], 56, axis=1) for h in h_sta]), q56)
    leak_db = 10 * np.log10(
        (np.abs(hq[:, 0, 1]) ** 2 + np.abs(hq[:, 1, 0]) ** 2).mean()
        / (np.abs(hq[:, 0, 0]) ** 2 + np.abs(hq[:, 1, 1]) ** 2).mean())
    log(f"mu (g): sounded both stations; leakage through the ZF Q of the "
        f"estimated channels {leak_db:.1f} dB")
    check(leak_db < -25.0, f"(g) ZF Q leaks {leak_db:.1f} dB")
    bfq = sounding.q_to_grid(q56)

    mu, sent, ams, arrs, seeds = mu_traffic(rng)
    waves_np = txe.tx_mu(mu, list(ams), bfq, seeds=seeds)
    check(waves_np.shape == (B_MU, 2, mu.n_samples),
          f"(g) tx_mu gave {waves_np.shape}")
    waves = from_numpy_cf(waves_np, dev)
    log(f"mu (g): TxEngine.tx_mu of {B_MU} PPDUs, nsym {mu.nsym}, "
        f"{mu.n_samples} samples each")

    # K1/K2 against their twins at the shapes the MU decode gives them:
    # B_MU rows, each user's trellis padded to 64s (uniform pm0 and the
    # argmax start are the window tiers' use of the same kernels)
    held, errs = [], [0.0, 0.0]
    krng = np.random.default_rng(61)
    for u in range(2):
        n_trellis = mu_user_cfg(mu, u).n_trellis
        llr = llr_pairs(torch, krng, dev, B_MU, n_trellis)
        e = hold_k1_k2(torch, VK, llr, f"the MU shape of user {u}: "
                       f"T={llr.shape[1]} (n_trellis {n_trellis}) B={B_MU}")
        errs = [max(a, b) for a, b in zip(errs, e)]
        held.append({"user": u, "T": llr.shape[1], "B": B_MU})
        del llr

    gen = torch.Generator(device=dev).manual_seed(59)
    out = {"mu_n_ok": [], "mu_lo_n_ok": [], "mu_k1_k2_held_at": held}
    launches = {"mu": {}, "mu_lo": {}}

    def add(into, counts):
        for k, v in counts.items():
            into[k] = into.get(k, 0) + v

    for u in range(2):
        heard = mu_heard(torch, CF, waves, h_sta[u][0])
        base, rms, spacing = lay_stream(torch, CF, heard, CFO_MU_HZ)
        stream = add_noise(torch, CF, base, rms, SNR_HI, gen)
        uc = mu.users[u]
        cfg = mu_user_cfg(mu, u)
        ml = len(sent[u][0])

        def count(c, st):
            return tuple(int(x) for x in PRX.rx_chain_count_mu(
                c, st, n_total=2, own=u, mpdu_len=ml, max_pkts=B_MU))

        (n_ok, n_det), counts = counted_run(
            torch, lambda: count(cfg, stream),
            f"mu (g) user {u} chain")
        add(launches["mu"], counts)
        check(n_det == B_MU, f"(g) user {u}: detected {n_det} of {B_MU}")
        check(n_ok >= 0.99 * B_MU, f"(g) user {u}: only {n_ok} of {B_MU} ok")
        out["mu_n_ok"].append(n_ok)
        wrong = PhyConfig(Fmt.VHT, uc.mcs + 1, 1, uc.psdu_len, ampdu=True,
                          mu_nsym=mu.nsym)
        n_ok_w, n_det_w = count(wrong, stream)
        check(n_det_w == B_MU and n_ok_w == 0,
              f"(g) user {u}: a wrong-MCS config counted {n_ok_w} ok")
        log(f"mu (g) user {u}: rx_chain_count_mu at {SNR_HI:g} dB "
            f"{n_det}/{B_MU} detected, {n_ok} ok; wrong-MCS "
            f"config {n_ok_w} ok")

        # the general engine on daemon-shaped blocks of the same stream
        x = to_numpy(stream)[0].astype(np.complex64)
        n_blocks = -(-len(x) // BLOCK)
        x = np.concatenate([x, np.zeros(n_blocks * BLOCK + HALO - len(x),
                                        np.complex64)])
        eng = PRX.RxEngine(nrx=1, mu_pos=u, mu_gid=2)
        (res, _, secs), counts = counted_run(
            torch, lambda: run_blocks(eng, x, n_blocks),
            f"mu (g) user {u} engine")
        add(launches["mu"], counts)
        n_dec = check_mu_results(res, sent[u], spacing, f"(g) user {u} engine")
        check(n_dec >= 0.99 * B_MU,
              f"(g) user {u}: the engine decoded {n_dec} of {B_MU}")
        other = PRX.RxEngine(nrx=1, mu_pos=u, mu_gid=5)
        res5, _, _ = run_blocks(other, x, 2)
        check(not [r for r in res5 if r.ok],
              f"(g) user {u}: group id 5 decoded {len(res5)} PPDUs")
        log(f"mu (g) user {u}: RxEngine(mu_pos={u}, mu_gid=2) on {n_blocks} "
            f"blocks: {n_dec}/{B_MU} PPDUs decoded, each to the MPDU sent, "
            f"{1e3 * sum(secs) / n_blocks:.1f} ms/block; mu_gid=5 decodes "
            "nothing")

        # (g') an SNR where rows leave the algebraic fast path
        lo = add_noise(torch, CF, base, rms, SNR_MU_LO, gen)
        (n_ok_lo, n_det_lo), moved = timing.with_counters(
            lambda: count(cfg, lo), dev)
        counts = timing.kernel_launches(moved)["launches"]
        rec = timing.decode_path(moved)
        add(launches["mu_lo"], counts)
        out["mu_lo_n_ok"].append(n_ok_lo)
        log(f"mu (g') user {u}: {SNR_MU_LO:g} dB: {n_det_lo}/{B_MU} detected, "
            f"{n_ok_lo} ok (recorded, not bounded), path {rec}, kernel "
            f"launches {counts}")
        check(rec and rec != ["fast"] and counts["acs_sweep"] > 0
              and counts["traceback_sweep"] > 0,
              f"(g') user {u}: the MU decode at {SNR_MU_LO:g} dB never "
              f"launched K1/K2: path {rec}, {counts}")
        n64 = 1024 + 64 * spacing
        first = CF(lo.re[:, :n64].contiguous(), lo.im[:, :n64].contiguous())
        both = []
        for d in (dev, "cpu"):
            st = CF(first.re.to(d), first.im.to(d))
            both.append([t.cpu() for t in PRX.rx_chain_ok_mu(
                cfg, st, n_total=2, own=u, mpdu_len=ml, max_pkts=64)])
        for name, a, b in zip(("ok", "ltf_idx", "valid"), *both):
            check(torch.equal(a, b),
                  f"(g') user {u}: card and CPU differ in {name}")
        check(int(both[0][2].sum()) == 64,
              f"(g') user {u}: {int(both[0][2].sum())} of 64 detected")
        log(f"mu (g') user {u}: rx_chain_ok_mu on the first 64 PPDUs, card "
            f"== CPU twins per packet ({int(both[0][0].sum())} ok)")
        if u == 0:
            station0 = (cfg, ml, base, rms, spacing)
            for snr, st in ((SNR_HI, stream), (SNR_MU_LO, lo)):
                out[f"rx_chain_count_mu_ms_{snr:g}dB"] = timed(
                    torch, lambda: count(cfg, st),
                    f"rx_chain_count_mu B={B_MU} user 0 VHT mcs3 at "
                    f"{snr:g} dB", B_MU, "PPDU", smi)
    log(f"mu: kernel launches on the MU path: {launches}")
    return launches, out, errs, station0


# ---------------------------------------------------------------------------
# streaming runtime and daemons
# ---------------------------------------------------------------------------

RING = 1 << 23                          # rx_daemon's ring, in samples
CHUNK = 1 << 16                         # rx_daemon's file-replay writes


class MacListener:
    """The MAC side of the PHY->MAC wire: a socket with a large receive
    buffer drained on its own thread, so a slow reader drops nothing."""

    def __init__(self):
        import socket
        import threading
        from gr_ieee80211_tpu_torch.runtime.udp_phy import parse_phy_to_mac
        self._parse = parse_phy_to_mac
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for opt in (getattr(socket, "SO_RCVBUFFORCE", None),
                    socket.SO_RCVBUF):
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, opt, 64 << 20)
                break
            except (OSError, TypeError):
                continue
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.1)
        self.port = self.sock.getsockname()[1]
        self.got: list = []
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def _run(self):
        import socket
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            self.got.append(self._parse(data))

    def wait_for(self, n: int, timeout: float = 30.0) -> list:
        deadline = time.time() + timeout
        while len(self.got) < n and time.time() < deadline:
            time.sleep(0.02)
        time.sleep(0.2)                  # a surplus datagram would show
        return list(self.got)

    def close(self):
        self._stop.set()
        self._th.join(timeout=5)
        self.sock.close()


class ClockedEngine:
    """The engine under the streamer, with the host clock read after each
    block it finishes and each block's kind ("spec" when the speculative
    one-pass decode ran; the streamer duck-types begin/finish_process)."""

    def __init__(self, eng):
        self.eng = eng
        self.done: list[float] = []
        self.kinds: list[str] = []

    def begin_process(self, view):
        handle = self.eng.begin_process(view)
        self.kinds.append(handle[2][0])
        return handle

    def finish_process(self, handle):
        res = self.eng.finish_process(handle)
        self.done.append(time.perf_counter())
        return res


def check_reports(got, sent, what):
    """The listener's datagrams are one [fmt, len, MPDU, mcs] per MPDU
    of each sent data packet, byte-equal, and one (2, 64) channel report
    per NDP; returns (data datagrams, NDP reports)."""
    from gr_ieee80211_tpu_torch.runtime.udp_phy import F_NDP_CHAN
    data = sorted((f, p, m) for f, p, m in got if f != F_NDP_CHAN)
    chans = [c for f, c, _ in got if f == F_NDP_CHAN]
    want = sorted((int(f["fmt"]), mp, f["mcs"]) for _, f in sent
                  if not f["is_ndp"] for mp in f["mpdus"])
    n_ndp = sum(f["is_ndp"] for _, f in sent)
    check(data == want, f"{what}: {len(data)} MPDU datagrams, "
          f"{len(want)} expected, or their bytes, fmt or mcs differ")
    check(len(chans) == n_ndp and all(
        c.shape == (2, 64) and np.isfinite(c).all() for c in chans),
        f"{what}: {len(chans)} NDP reports for {n_ndp} NDPs")
    return len(data), len(chans)


def stream_run(streamer, rings, feed, what, timeout=600.0):
    """Start the streamer, run ``feed()``, drain and join it; fails on a
    thread error.  Returns what ``feed`` returned."""
    streamer.start()
    out = feed()
    streamer.stop(drain=True, timeout=timeout)
    streamer.join(timeout=timeout)
    check(not streamer.is_alive(), f"{what}: the streamer did not stop")
    check(streamer.error is None, f"{what}: the streamer died: "
          f"{streamer.error!r}")
    for r in rings:
        r.close()
    return out


def replay(NAT, RS, U, eng, stream, what, mac=None, on_result=None):
    """``rx_daemon.py --file``'s replay: the stream written in CHUNK
    pieces with backpressure into an ``IqRing(RING)`` -> ``RxStreamer``
    over ``eng`` (a ``ClockedEngine``) -> ``PhyRxReporter`` to ``mac``
    when one is given; drains and joins.  Returns (streamer, host clock
    at the first write)."""
    ring = NAT.IqRing(RING)
    streamer = RS.RxStreamer(
        ring, eng, block_len=BLOCK, halo=HALO,
        reporter=None if mac is None else U.PhyRxReporter(port=mac.port),
        on_result=on_result)

    def feed():
        t_first, off = time.perf_counter(), 0
        while off < len(stream):
            off += ring.write(stream[off: off + CHUNK])
            time.sleep(0.001)
        return t_first

    return streamer, stream_run(streamer, [ring], feed, what)


def phase_replay(torch, PRX, NAT, RS, U, engine_ms, smi, shapes):
    """(h1) engine (b)'s daemon stream replayed through IqRing ->
    RxStreamer -> RxEngine -> PhyRxReporter -> a MAC listener."""
    stream, sent = daemon_stream(np.random.default_rng(23))
    eng = ClockedEngine(PRX.RxEngine(nrx=1, device="cuda"))
    results = []
    mac = MacListener()
    (streamer, t_first), counts = counted_run(
        torch, lambda: replay(NAT, RS, U, eng, stream, "(h1)", mac,
                                  results.append),
        "stream (h1) replay", shapes)
    check_sent(results, sent, "stream (h1)")
    check(streamer.n_packets == streamer.n_ok == len(sent),
          f"(h1): streamer counted {streamer.n_ok}/{streamer.n_packets}")
    n_data, n_ndp = check_reports(
        mac.wait_for(sum(len(f["mpdus"]) or 1 for _, f in sent)), sent,
        "stream (h1)")
    mac.close()
    secs = eng.done[N_BLOCKS - 1] - t_first
    per_block = np.diff([t_first] + eng.done[:N_BLOCKS]) * 1e3
    n_spec = eng.kinds[:N_BLOCKS].count("spec")
    log(f"stream (h1): ms per block {np.round(per_block, 1).tolist()}, "
        f"kinds {eng.kinds[:N_BLOCKS]}")
    out = {"h1_ms_per_block": 1e3 * secs / N_BLOCKS,
           "h1_speculative_blocks": n_spec,
           "h1_msamples_per_s": N_BLOCKS * BLOCK / secs / 1e6,
           "h1_engine_b_ms_per_block": engine_ms,
           "h1_packets": len(sent), "h1_ok": streamer.n_ok,
           "h1_blocks_run": streamer.n_blocks,
           "h1_datagrams": n_data + n_ndp, "h1_ndp_reports": n_ndp}
    log(f"stream (h1): {len(sent)} packets in {N_BLOCKS} blocks of {BLOCK} + "
        f"{HALO} through IqRing -> RxStreamer -> RxEngine: {streamer.n_ok} "
        f"ok, each decoded once; {n_data} MPDU datagrams and {n_ndp} NDP "
        f"reports received byte-equal; {out['h1_ms_per_block']:.1f} ms/block "
        f"({out['h1_msamples_per_s']:.2f} Msamples/s) from the first write to "
        f"the last owned block, engine (b) in this run {engine_ms:.1f} "
        f"ms/block; {streamer.n_blocks - N_BLOCKS} drain block(s); {smi}")
    return counts, out, stream, sent


def loopback_requests(rng):
    """(datagrams, sent) of the MAC side: L MCS0-7, HT MCS0-7 and VHT
    MCS0-8 once each plus 8 more drawn at random, 100-1500 B, in the
    reference's 5-byte-header format, and one VHT NDP request."""
    from gr_ieee80211_tpu_torch.gold import mac
    from gr_ieee80211_tpu_torch.spec.params import Fmt
    kinds = [(f, m) for f, n in ((Fmt.L, 8), (Fmt.HT, 8), (Fmt.VHT, 9))
             for m in range(n)]
    kinds += [kinds[int(i)] for i in rng.integers(0, len(kinds), 8)]
    reqs, sent = [], []
    for k, (fmt, mcs) in enumerate(kinds):
        mpdu = mac.qos_data_frame(bytes(rng.integers(
            0, 256, int(rng.integers(100, 1501)), dtype=np.uint8)),
            *ADDR, k)
        psdu = mac.ampdu_aggregate_vht([mpdu]) if fmt == Fmt.VHT else mpdu
        reqs.append(bytes([int(fmt), mcs, 1, len(psdu) & 0xFF,
                           len(psdu) >> 8]) + psdu)
        sent.append((k, dict(fmt=fmt, mcs=mcs, mpdus=[mpdu], is_ndp=False)))
    reqs.append(b"\x02\x00\x02\x00\x00")
    sent.append((len(kinds), dict(fmt=Fmt.VHT, mcs=0, mpdus=[], is_ndp=True)))
    return reqs, sent


def loopback(torch, PRX, NAT, RS, U, reqs, sent, nrx, what):
    """MAC -> PhyTxServer(device_tx on the card) -> TxStreamer -> cf32 UDP
    -> UdpIngest (one per antenna) -> rings -> RxStreamer -> RxEngine ->
    PhyRxReporter -> the MAC listener; returns the ingest statistics."""
    import socket
    rings = [NAT.IqRing(RING) for _ in range(nrx)]
    ings = [NAT.UdpIngest(r, port=0) for r in rings]
    mac = MacListener()
    streamer = RS.RxStreamer(rings, PRX.RxEngine(nrx=nrx, device="cuda"),
                             block_len=BLOCK, halo=HALO,
                             reporter=U.PhyRxReporter(port=mac.port))
    sink = RS.TxStreamer(udp_addr=[("127.0.0.1", i.port) for i in ings],
                         gap=1200, amp=0.2)
    srv = U.PhyTxServer(sink=sink, port=0, device_tx=True, device="cuda")

    def feed():
        srv.start()
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for d in reqs:
            tx.sendto(d, ("127.0.0.1", srv.port))
            time.sleep(0.002)
        tx.close()
        deadline = time.time() + 300
        while sink.n_bursts < len(reqs) and time.time() < deadline:
            time.sleep(0.02)
        check(sink.n_bursts == len(reqs),
              f"{what}: {sink.n_bursts} of {len(reqs)} bursts synthesized")
        while (min(i.stats["samples"] for i in ings) < sink.stream_pos
               and time.time() < deadline):
            time.sleep(0.02)
        srv.stop()
        srv.join(timeout=10)
        sink.close()
        for i in ings:                   # the drain's silence is the only
            i.stop()                     # writer from here on
        return [i.stats for i in ings]

    stats = stream_run(streamer, rings, feed, what)
    check(all(s["samples"] == sink.stream_pos and s["dropped"] == 0
              for s in stats),
          f"{what}: ingest {stats}, {sink.stream_pos} samples sent per "
          "antenna")
    n_data, n_ndp = check_reports(mac.wait_for(len(sent)), sent, what)
    mac.close()
    log(f"{what}: {len(reqs)} MAC requests -> {sink.n_bursts} bursts on "
        f"{nrx} antenna(s) -> {n_data} MPDUs back byte-equal with fmt and "
        f"mcs, {n_ndp} NDP report(s); ingest {stats}")
    return stats, n_data + n_ndp


def phase_loopback(torch, PRX, NAT, RS, U, shapes):
    """(h2) the rx.grc/tx.grc loopback, MAC to MAC, at 1 and 2 antennas."""
    from gr_ieee80211_tpu_torch.gold import mac
    from gr_ieee80211_tpu_torch.spec.params import Fmt
    rng = np.random.default_rng(37)
    reqs, sent = loopback_requests(rng)
    (st1, n1), c1 = counted_run(
        torch, lambda: loopback(torch, PRX, NAT, RS, U, reqs, sent, 1,
                                    "stream (h2) 1 antenna"),
        "stream (h2) 1 antenna", shapes)
    # tests/test_streaming2x2.py's traffic, widened: VHT 2-SS bursts carry
    # both antennas, 1-SS bursts zero-fill antenna 1 (pad2)
    reqs2, sent2 = [], []
    for k, (mcs, nss) in enumerate(((4, 2), (5, 1), (0, 2), (8, 1), (7, 2),
                                    (2, 1))):
        mpdu = mac.qos_data_frame(bytes(rng.integers(
            0, 256, int(rng.integers(100, 1501)), dtype=np.uint8)),
            *ADDR, 100 + k)
        psdu = mac.ampdu_aggregate_vht([mpdu])
        reqs2.append(bytes([2, mcs, nss, len(psdu) & 0xFF, len(psdu) >> 8])
                     + psdu)
        sent2.append((k, dict(fmt=Fmt.VHT, mcs=mcs, mpdus=[mpdu],
                              is_ndp=False)))
    (st2, n2), c2 = counted_run(
        torch, lambda: loopback(torch, PRX, NAT, RS, U, reqs2, sent2, 2,
                                    "stream (h2) 2 antennas"),
        "stream (h2) 2 antennas", shapes)
    counts = {k: c1[k] + c2[k] for k in c1}
    out = {"h2_requests": len(reqs) + len(reqs2), "h2_datagrams": n1 + n2,
           "h2_ingest_dropped": sum(s["dropped"] for s in st1 + st2),
           "h2_ingest_samples": [s["samples"] for s in st1 + st2]}
    return counts, out


def phase_cmu_demo():
    """(h3) tools_torch/cmu_demo.py on the card, in this process."""
    import contextlib
    import io
    from tools_torch import cmu_demo
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cmu_demo.main(["--device", "cuda"])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  cmu_demo: {line}")
    check(rc == 0 and "closed loop: SUCCESS" in text,
          f"(h3) cmu_demo returned {rc}")
    log("stream (h3): MU closed loop over real sockets, closed loop: SUCCESS")


def phase_daemon(stream, sent):
    """(h4) the user's entry point: rx_daemon.py --file ... --once on the
    first 4 blocks of (h1)'s stream, reporting to a MAC listener."""
    import re
    root = Path(__file__).resolve().parent
    n_own = 4 * BLOCK
    first = [(s, f) for s, f in sent if s < n_own]
    cut = min(s for s, _ in sent if s >= n_own) - 100
    path = root / "build" / "chip_smoke" / "daemon_4_blocks.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    stream[:cut].tofile(path)
    mac = MacListener()
    try:
        tic = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "tools_torch/rx_daemon.py", "--file", str(path),
             "--once", "--device", "cuda", "--report-port", str(mac.port)],
            cwd=root, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - tic
        for line in out.stderr.splitlines()[-6:]:
            log(f"  rx_daemon: {line}")
        m = re.search(r"done: (\d+) blocks, (\d+)/(\d+) packets ok",
                      out.stderr)
        check(out.returncode == 0 and m is not None,
              f"(h4) rx_daemon exited {out.returncode}")
        n_ok, n_pk = int(m.group(2)), int(m.group(3))
        check(n_ok == n_pk == len(first),
              f"(h4) rx_daemon: {n_ok}/{n_pk} ok, {len(first)} sent")
        n_data, n_ndp = check_reports(
            mac.wait_for(sum(len(f["mpdus"]) or 1 for _, f in first)),
            first, "stream (h4)")
    finally:
        mac.close()
        path.unlink(missing_ok=True)
    log(f"stream (h4): rx_daemon.py --file ({cut} samples) --once --device "
        f"cuda: {m.group(0)}, {n_data + n_ndp} datagrams, {secs:.1f} s with "
        "the process start")
    return {"h4_packets": len(first), "h4_ok": n_ok,
            "h4_datagrams": n_data + n_ndp}


def phase_streaming(torch, PRX, engine_ms, smi):
    """(h) the streaming runtime and daemons on the card; returns the
    kernels' launch counts of (h1) + (h2) and K1/K2's launch shapes there
    (the streaming numbers go to a log line)."""
    from gr_ieee80211_tpu_torch.runtime import native as NAT
    from gr_ieee80211_tpu_torch.runtime import streaming as RS
    from gr_ieee80211_tpu_torch.runtime import udp_phy as U
    check(NAT.available(), "(h): the native runtime (libphyrt) did not load")
    shapes = set()
    c1, out, stream, sent = phase_replay(torch, PRX, NAT, RS, U,
                                         engine_ms, smi, shapes)
    c2, out2 = phase_loopback(torch, PRX, NAT, RS, U, shapes)
    phase_cmu_demo()
    out.update(out2)
    out.update(phase_daemon(stream, sent))
    launches = {k: c1[k] + c2[k] for k in c1}
    check(launches["acs_sweep"] > 0 and launches["traceback_sweep"] > 0,
          f"(h): the streamer never launched K1/K2: {launches}")
    out["card"] = smi
    log(json.dumps({"streaming": out}))
    return launches, shapes


# ---------------------------------------------------------------------------
# scale-out: the sharded programs, in one process and in two
# ---------------------------------------------------------------------------

N_SHARDS = 4                            # on one card, unless there are more
B_DP2 = 1024                            # (i4) 2x2 windows
SHARD_MARGIN = 64                       # packets a shard may hold above B/n


def median_ms(torch, fn, reps=5, warm=True):
    """Median milliseconds of ``reps`` calls of ``fn``, each between two
    CUDA events (after one untimed call when ``warm``)."""
    if warm:
        fn()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts))


def small_sharded_stream(seed, snr_db, cfo_hz, num, gap):
    """tests/test_mesh.py's streams: ``num`` copies of one VHT MCS4 A-MPDU
    (a random 80 B payload from ``seed``), zero-padded to 8 shards;
    returns (cfg, mpdu_len, stream)."""
    from gr_ieee80211_tpu_torch.gold import channel, mac, tx
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    rng = np.random.default_rng(seed)
    mpdu = mac.qos_data_frame(bytes(rng.integers(0, 256, 80, dtype=np.uint8)),
                              *ADDR, 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 4, 1, len(am), ampdu=True)
    wave = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    s = channel.frame_stream(wave, 1.0, cfo_hz, num=num, gap=gap)[0]
    if snr_db is not None:
        rms = np.sqrt(np.mean(np.abs(wave) ** 2))
        s = channel.awgn(s[None], rms / 10 ** (snr_db / 20), rng)[0]
    s = np.pad(s, (0, -len(s) % 8)).astype(np.complex64)
    return cfg, len(mpdu), s


def mesh_card_vs_cpu(torch, M, from_numpy_cf, dev):
    """(i2) tests/test_mesh.py's two streams through rx_chain_sp and
    frontend_sp on 8 shards, on the card and on the CPU."""
    cfg, ml, s11 = small_sharded_stream(11, 30.0, 600.0, 12, 1400)
    _, _, s13 = small_sharded_stream(13, None, 0.0, 6, 2000)
    got = {}
    for d in (dev.type, "cpu"):
        mesh = M.make_mesh(8, axes=("sp",), device=d)
        chain, _ = M.rx_chain_sp(cfg, mesh, mpdu_len=ml, max_pkts_per_shard=16)
        got[d] = (tuple(int(x) for x in chain(from_numpy_cf(s11, d))),
                  M.frontend_sp(mesh, max_out_per_shard=64)(
                      from_numpy_cf(s13, d)).cpu())
    (c_card, f_card), (c_cpu, f_cpu) = got[dev.type], got["cpu"]
    check(c_card == c_cpu, f"(i2) rx_chain_sp: card {c_card}, CPU {c_cpu}")
    check(c_card[1] == 12, f"(i2) rx_chain_sp detected {c_card[1]} of 12")
    check(torch.equal(f_card, f_cpu),
          "(i2) frontend_sp: card and CPU candidates differ")
    log(f"mesh (i2): 12-packet 30 dB stream on 8 shards, rx_chain_sp card == "
        f"CPU {c_card}; frontend_sp card == CPU, {int((f_card >= 0).sum())} "
        "candidates")
    return {"i2_counts": list(c_card)}


def mesh_workers(mode, n_local, iq, dev, extra=()):
    """(i6) tools_torch/mesh_worker.py as 2 processes over Gloo on the
    card, ``n_local`` shards each; returns each rank's ((n_ok, n_det),
    ms, launches)."""
    import re
    import socket
    root = Path(__file__).resolve().parent
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "tools_torch/mesh_worker.py", str(r), "2", str(port),
         mode, "--local-shards", str(n_local), "--backend", "gloo",
         "--device", dev.type, "--iq", str(iq), "--reps", "3", *extra],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines()[-4:]:
            log(f"  mesh_worker {mode} rank {r}: {line}")
        m = re.search(r"RESULT ok=(\d+) det=(\d+)", text)
        t = re.search(rf"{mode.upper()}TIME ms=([0-9.]+)", text)
        n = re.search(r"LAUNCHES (\{.*\})", text)
        check(p.returncode == 0 and m and t and n,
              f"(i6) {mode} rank {r} exited {p.returncode}:\n{text[-2000:]}")
        res.append(((int(m.group(1)), int(m.group(2))), float(t.group(1)),
                    json.loads(n.group(1))))
    return res


def phase_mesh(torch, PRX, CF, from_numpy_cf, bench, chain_res,
               station0, dev, smi):
    """(i) the sharded programs on the card at the bench's size; returns
    (the kernels' launch counts, K1/K2's launch shapes, the mesh line)."""
    from gr_ieee80211_tpu_torch import entry as E
    from gr_ieee80211_tpu_torch.parallel import mesh as M
    from tools_torch.mesh_worker import save_capture
    cfg, mpdu, am, wave, streams = bench
    ml = len(mpdu)
    n = max(N_SHARDS, torch.cuda.device_count()) if dev.type == "cuda" \
        else N_SHARDS
    mesh_sp = M.make_mesh(n, axes=("sp",), device=dev.type)
    mesh_dp = M.make_mesh(n, axes=("dp",), device=dev.type)
    launches, shapes = {}, set()
    out = {"shards": n, "devices": [str(d) for d in mesh_sp.shards],
           "shard_samples": len(streams[SNR_HI]) // n}

    def tally(fn, what):
        res, counts = counted_run(torch, fn, f"mesh {what}", shapes)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return res, counts

    # (i1) the time-sharded chain on the bench streams
    max_pkts = B // n + SHARD_MARGIN
    chain, halo = M.rx_chain_sp(cfg, mesh_sp, mpdu_len=ml,
                                max_pkts_per_shard=max_pkts)
    sp = {}
    for snr in (SNR_HI, SNR_LO):
        st = from_numpy_cf(streams[snr], dev)
        rec, counts = tally(lambda: tuple(int(x) for x in chain(st)),
                            f"(i1) rx_chain_sp {snr:g} dB")
        sp[snr] = rec
        check(rec[1] == B, f"(i1) {snr:g} dB: detected {rec[1]} of {B}")
        if snr == SNR_HI:
            check(rec[0] >= 0.99 * B, f"(i1) 32 dB: only {rec[0]} ok")
        else:
            check(counts["acs_sweep"] > 0 and counts["traceback_sweep"] > 0,
                  f"(i1) 18 dB never launched K1/K2: {counts}")
        st1 = CF(st.re[None], st.im[None])
        ms = median_ms(torch, lambda: chain(st))
        ms1 = median_ms(torch, lambda: PRX.rx_chain_count(
            cfg, st1, mpdu_len=ml, max_pkts=B))
        log(f"mesh (i1) rx_chain_sp {snr:g} dB, {n} shards of "
            f"{out['shard_samples']} samples (halo {halo}, left {M.LH}, "
            f"{max_pkts} packets a shard at most): (n_ok, n_det) = {rec}, "
            f"single-device chain (phase 4) {chain_res[snr]}; {ms:.2f} "
            f"ms/call against the single-device chain's {ms1:.2f} (CUDA "
            f"events, warmed, median of 5; the shards run one after another "
            f"on {mesh_sp.shards[0]}; {smi})")
        out[f"i1_{snr:g}dB"] = {"n_ok": rec[0], "n_det": rec[1],
                                "single_n_ok": chain_res[snr][0],
                                "ms": ms, "single_ms": ms1}
        del st, st1

    out.update(mesh_card_vs_cpu(torch, M, from_numpy_cf, dev))

    # (i3) the per-sample front end on the bench's packets without noise
    from tools_torch import bench as TB
    base, spacing = TB.lay(wave, B), len(wave) + TB.GAP
    placed = 1024 + spacing * np.arange(B)
    max_out = 3 * B // n
    det = M.frontend_sp(mesh_sp, max_out_per_shard=max_out)
    st = from_numpy_cf(base, dev)
    cand, _ = tally(lambda: det(st).cpu().numpy(), "(i3) frontend_sp")
    per_shard = (cand >= 0).sum(axis=1)
    check(per_shard.max() < max_out, f"(i3) a shard filled {max_out} slots")
    trigs = PRX.dedup_triggers(np.sort(cand[cand >= 0]))
    check(len(trigs) == B, f"(i3) {len(trigs)} triggers for {B} packets")
    err = trigs - placed
    check(bool((err >= -64).all() and (err <= 8).all()),
          f"(i3) trigger offsets {err.min()}..{err.max()} outside [-64, 8]")
    ms = median_ms(torch, lambda: det(st))
    log(f"mesh (i3) frontend_sp: {int(per_shard.sum())} candidates "
        f"({per_shard.tolist()} a shard), {len(trigs)} triggers after dedup "
        f"for {B} packets, offsets {int(err.min())}..{int(err.max())}; "
        f"{ms:.2f} ms/call ({smi})")
    out["i3"] = {"candidates": per_shard.tolist(), "triggers": len(trigs),
                 "offset_min": int(err.min()), "offset_max": int(err.max()),
                 "ms": ms}
    del st

    # (i4) packet-sharded decode of aligned windows (the scan Viterbi, K6)
    step, n_samp = M.payload_decode_dp(cfg, mesh_dp, mpdu_len=ml)
    starts = 1024 + spacing * np.arange(B) + 188
    wins = streams[SNR_HI][starts[:, None] + np.arange(n_samp)[None]]
    wd = from_numpy_cf(wins, dev)
    (psdu, ok, total), counts = tally(lambda: step(wd), "(i4) dp decode")
    total = int(total)
    check(total == int(ok.sum()), f"(i4) total {total} != {int(ok.sum())}")
    check(total >= 0.99 * B, f"(i4) only {total} of {B} passed FCS")
    rows = np.arange(0, B, B // 16)
    check(bool((psdu[torch.from_numpy(rows), : len(am)].cpu().numpy()
                == np.frombuffer(am, np.uint8)[None]).all()),
          "(i4) sampled PSDUs differ from the bytes sent")
    once = ("scan_viterbi", "payload_demod")
    check(all(counts[k] == len(mesh_dp.shards) for k in once)
          and not any(v for k, v in counts.items() if k not in once),
          f"(i4) launched other than K8 and K6 once a shard: {counts}")
    ms = median_ms(torch, lambda: step(wd), reps=3, warm=False)
    log(f"mesh (i4) payload_decode_dp: {B} windows of {n_samp} samples on "
        f"{n} shards, {total} pass FCS, {len(rows)} sampled PSDUs equal the "
        f"bytes sent; {ms:.1f} ms/call (CUDA events, median of 3; "
        f"demodulation K8, scan Viterbi K6, "
        f"{-(-cfg.n_trellis // 54) * 54} steps; {smi})")
    out["i4"] = {"windows": B, "ok": total, "ms": ms}
    from gr_ieee80211_tpu_torch.gold import mac, tx
    from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
    m2 = mac.qos_data_frame(b"x" * 40, *ADDR, 1)
    am2 = mac.ampdu_aggregate_vht([m2])
    cfg2 = PhyConfig(Fmt.VHT, 2, 2, len(am2), ampdu=True)
    rng = np.random.default_rng(0)
    h2 = np.eye(2) + 0.25 * (rng.normal(size=(2, 2))
                             + 1j * rng.normal(size=(2, 2)))
    mixed = h2 @ tx.tx_waveform(cfg2, am2, group_id=0, partial_aid=0)
    step2, n_samp2 = M.payload_decode_dp(cfg2, mesh_dp, mpdu_len=len(m2),
                                         nrx=2)
    w2 = from_numpy_cf(np.tile(mixed[:, 188: 188 + n_samp2][None],
                               (B_DP2, 1, 1)).astype(np.complex64), dev)
    (_, _, total2), _ = tally(lambda: step2(w2), "(i4) dp 2x2 decode")
    check(int(total2) == B_DP2, f"(i4) 2x2: {int(total2)} of {B_DP2} ok")
    ms2 = median_ms(torch, lambda: step2(w2), reps=3, warm=False)
    log(f"mesh (i4) payload_decode_dp nrx=2: {B_DP2} VHT mcs2 2-SS windows "
        f"through a seeded 2x2 mix, {int(total2)} pass FCS; {ms2:.1f} ms/call")
    out["i4_2x2"] = {"windows": B_DP2, "ok": int(total2), "ms": ms2}
    del wd, w2

    # (i5) the MU station chain, one capture of phase (g) a shard
    cfg_u, ml_u, base_u, rms_u, spacing_u = station0
    per = B_MU // n
    L = per * spacing_u
    c0 = 1024 - GAP // 2                # each capture starts in a gap
    mu_chain = M.mu_chain_dp(cfg_u, mesh_dp, n_total=2, own=0, mpdu_len=ml_u,
                             max_pkts_per_shard=per + SHARD_MARGIN)
    gen = torch.Generator(device=dev).manual_seed(71)
    out["i5"] = {}
    for snr in (SNR_HI, SNR_MU_LO):
        s = add_noise(torch, CF, base_u, rms_u, snr, gen)
        caps = CF(s.re[0, c0: c0 + n * L].reshape(n, L),
                  s.im[0, c0: c0 + n * L].reshape(n, L))
        rec, counts = tally(lambda: tuple(int(x) for x in mu_chain(caps)),
                            f"(i5) mu_chain_dp {snr:g} dB")
        if snr == SNR_HI:
            check(rec[1] == B_MU and rec[0] >= 0.99 * B_MU,
                  f"(i5) 32 dB: {rec} of {B_MU}")
        else:
            check(counts["acs_sweep"] > 0 and counts["traceback_sweep"] > 0,
                  f"(i5) {snr:g} dB never launched K1/K2: {counts}")
        ms = median_ms(torch, lambda: mu_chain(caps))
        log(f"mesh (i5) mu_chain_dp {snr:g} dB: {n} captures of {per} PPDUs "
            f"({L} samples), (n_ok, n_det) = {rec}; {ms:.2f} ms/call")
        out["i5"][f"{snr:g}dB"] = {"n_ok": rec[0], "n_det": rec[1], "ms": ms}

    # (i6) two processes over Gloo, each with half the shards and half the
    # input (the shards' kernels load the library built above)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    sp_iq, dp_iq = work / "mesh_sp18.npy", work / "mesh_dp32.npy"
    save_capture(sp_iq, streams[SNR_LO], cfg, ml)
    save_capture(dp_iq, wins, cfg, ml)
    del wins
    torch.cuda.empty_cache()
    try:
        ranks_sp = mesh_workers("sp", n // 2, sp_iq, dev,
                                ("--max-pkts", str(max_pkts)))
        ranks_dp = mesh_workers("dp", n // 2, dp_iq, dev)
    finally:
        for f in (sp_iq, dp_iq):
            f.unlink(missing_ok=True)
            f.with_suffix(".json").unlink(missing_ok=True)
    for r, (rec, _, _) in enumerate(ranks_sp):
        check(rec == sp[SNR_LO], f"(i6) sp rank {r}: {rec}, (i1) 18 dB "
              f"{sp[SNR_LO]}")
    for r, (rec, _, _) in enumerate(ranks_dp):
        check(rec == (total, B), f"(i6) dp rank {r}: {rec}, (i4) {total}")
    out["i6"] = {"sp": [rec for rec, _, _ in ranks_sp][0],
                 "sp_ms": [t for _, t, _ in ranks_sp],
                 "dp": [rec for rec, _, _ in ranks_dp][0],
                 "dp_ms": [t for _, t, _ in ranks_dp],
                 "launches": [ln for _, _, ln in ranks_sp + ranks_dp]}
    log(f"mesh (i6) 2 processes x {n // 2} shards over Gloo on "
        f"{mesh_sp.shards[0]}: sp {out['i6']['sp']} on both ranks (== (i1) 18 "
        f"dB), SPTIME {out['i6']['sp_ms']} ms; dp {out['i6']['dp']} on both "
        f"(== (i4)), DPTIME {out['i6']['dp_ms']} ms (two ranks time-share "
        "one card: not a scaling figure)")

    # (i7) the entry twin and the dry run of every sharded program
    import contextlib
    import io
    fn, args = E.entry(dev.type)
    psdu, _ = tally(lambda: fn(*args), "(i7) entry")
    want = (8, PhyConfig(Fmt.VHT, 7, 1, 520, ampdu=True).psdu_len)
    check(tuple(psdu.shape) == want and psdu.dtype == torch.uint8
          and psdu.device.type == dev.type,
          f"(i7) entry gave {tuple(psdu.shape)} {psdu.dtype} on {psdu.device}")
    buf = io.StringIO()

    def dryrun():
        with contextlib.redirect_stdout(buf):
            E.dryrun_multichip(n, device=dev.type)

    tally(dryrun, "(i7) dryrun_multichip")
    line = buf.getvalue().strip().splitlines()[-1]
    check(line.startswith("dryrun ok:"), f"(i7) dryrun printed {line!r}")
    log(f"mesh (i7): entry() psdu {tuple(psdu.shape)} {psdu.dtype}; "
        f"dryrun_multichip({n}): {line}")
    out["i7"] = line
    log(f"mesh: kernel launches in (i1), (i3)-(i5), (i7): {launches}")
    check(launches["acs_sweep"] > 0 and launches["traceback_sweep"] > 0,
          f"(i) the sharded programs never launched K1/K2: {launches}")
    out["card"] = smi
    log(json.dumps({"mesh": out}))
    return launches, shapes


# ---------------------------------------------------------------------------
# (j) the harness tools, each as a user runs it
# ---------------------------------------------------------------------------

TOOLS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_tools"
TOOL_LANES = 4                          # tool processes at once on the card
T_LONG = 32320                          # bench_long's trellis, padded to 64s
PER_N = 100                             # perf_sweep packets a point
LONG_B = 1024                           # bench_long's default batch
#: the JAX package's PER curves for phase (j)'s three sweeps
PER_REFERENCE = (Path(__file__).resolve().parent / "tests" / "golden"
                 / "per_sweep_jax.json")


def tool_runs(out: Path) -> dict:
    """name -> argv of every tool run of phase (j); outputs under ``out``."""
    py = sys.executable
    per = [py, "tools_torch/perf_sweep.py"]
    sweep = ["--n", str(PER_N), "--snrs", "0", "31", "3"]
    tie = ["--formats", "VHT", "--mcs", "4", "--n", "8", "--snrs", "9", "16",
           "3"]
    # the longest runs first, so that they overlap the rest
    return {
        "multihost_scaling": [py, "tools_torch/multihost_scaling.py",
                              "--out", str(out / "multihost.json")],
        "bench_snr_sweep": [py, "tools_torch/bench_snr_sweep.py",
                            "--out", str(out / "snr.json")],
        "bench_long": [py, "tools_torch/bench_long.py",
                       "--out", str(out / "long.json")],
        "bench": [py, "tools_torch/bench.py", "--reps", "5",
                  "--out", str(out / "bench.json")],
        "perf_sweep": per + ["--formats", "VHT", *sweep,
                             "--out", str(out / "per_vht.json")],
        "perf_sweep_lht": per + ["--formats", "L", "HT", "--mcs", "0", "1",
                                 "2", "3", *sweep,
                                 "--out", str(out / "per_lht.json")],
        "perf_sweep_2ss": per + ["--nss", "2", "--formats", "VHT", "--mcs",
                                 "3", *sweep,
                                 "--out", str(out / "per_2ss.json")],
        "perf_sweep_mu": per + ["--mu", "--mcs", "3", *sweep,
                                "--out", str(out / "per_mu.json")],
        "perf_sweep_card": per + [*tie, "--out", str(out / "tie_card.json"),
                                  "--dump", str(out / "tie_card")],
        "perf_sweep_cpu": per + [*tie, "--device", "cpu",
                                 "--out", str(out / "tie_cpu.json"),
                                 "--dump", str(out / "tie_cpu")],
        "bench_tx": [py, "tools_torch/bench_tx.py",
                     "--out", str(out / "tx.json")],
        "bench_tx_mu": [py, "tools_torch/bench_tx.py", "--mu",
                        "--out", str(out / "tx_mu.json")],
        "bench_mu": [py, "tools_torch/bench_mu.py",
                     "--out", str(out / "mu.json")],
        "bench_daemon": [py, "tools_torch/bench_daemon.py", "--rates", "2,5",
                         "--seconds", "3", "--resident-blocks", "3",
                         "--out", str(out / "daemon.json")],
        "latency_report": [py, "tools_torch/latency_report.py", "7", "3",
                           "1,256", "--out", str(out / "latency.json")],
    }


def run_tools(runs: dict, lanes: int) -> dict:
    """Every run as a subprocess, ``lanes`` at a time; name -> (exit code,
    seconds, the end of its output)."""
    root = Path(__file__).resolve().parent
    todo, live, done = list(runs.items()), {}, {}
    try:
        while todo or live:
            while todo and len(live) < lanes:
                name, argv = todo.pop(0)
                log_f = open(TOOLS_DIR / f"{name}.log", "w")
                live[name] = (subprocess.Popen(
                    argv, cwd=root, stdout=log_f, stderr=subprocess.STDOUT),
                    log_f, time.perf_counter())
            time.sleep(0.5)
            for name, (p, log_f, tic) in list(live.items()):
                if p.poll() is None and time.perf_counter() - tic < 900:
                    continue
                if p.poll() is None:
                    p.kill()
                p.wait()
                log_f.close()
                text = (TOOLS_DIR / f"{name}.log").read_text()
                done[name] = (p.returncode, time.perf_counter() - tic,
                              text[-3000:])
                del live[name]
                log(f"tools (j): {name} exited {p.returncode} in "
                    f"{done[name][1]:.1f} s")
    finally:
        for p, log_f, _ in live.values():
            p.kill()
            p.wait()
            log_f.close()
    return done


def check_sweep(name, blob, ref):
    """Every configuration of a sweep against the JAX package's curve for
    the same command (``PER_REFERENCE``, made by ``tools_tpu/perf_sweep.py``
    on the CPU from the same seed): each point within 1/n of it (the one
    LTF near-tie slot a point may differ by), PER 0 at 30 dB, and PER never
    rising by more than 2/n from one point to the next unless the
    reference rises by more than that at the same point (its receiver's
    sync misses a few packets in the middle of some waterfalls)."""
    for cfg, v in blob.items():
        if cfg == "device":
            continue
        per, want, n = v["per"], ref[cfg]["per"], v["n"]
        check(v["snr_db"] == ref[cfg]["snr_db"] and n == ref[cfg]["n"],
              f"(j) {name} {cfg}: not the reference's sweep")
        dev = max(abs(a - b) for a, b in zip(per, want))
        check(dev <= 1.0 / n + 1e-12,
              f"(j) {name} {cfg}: PER {per}, the JAX package's {want}")
        check(v["snr_db"][-1] == 30.0 and per[-1] == 0.0,
              f"(j) {name} {cfg}: PER {per[-1]} at {v['snr_db'][-1]} dB")
        for i in range(len(per) - 1):
            rise, ref_rise = per[i + 1] - per[i], want[i + 1] - want[i]
            check(rise <= 2.0 / n + 1e-12 or ref_rise > 2.0 / n + 1e-12,
                  f"(j) {name} {cfg}: PER rises by {rise} at "
                  f"{v['snr_db'][i + 1]} dB (the reference by {ref_rise}): "
                  f"{per}")


def tool_kernels(blob, acc_launches: dict, shapes: set):
    """Add every ``launches`` / ``k1_k2_shapes`` pair found in a tool's
    JSON to the phase's totals."""
    if isinstance(blob, dict):
        if "launches" in blob and "k1_k2_shapes" in blob:
            for k, v in blob["launches"].items():
                acc_launches[k] = acc_launches.get(k, 0) + v
            shapes.update(tuple(bt) for bt in blob["k1_k2_shapes"])
        for v in blob.values():
            if isinstance(v, (dict, list)):
                tool_kernels(v, acc_launches, shapes)
    elif isinstance(blob, list):
        for v in blob:
            tool_kernels(v, acc_launches, shapes)


def phase_tools(torch, smi):
    """(j) every harness tool of tools_torch/ on the card as a subprocess;
    returns (the kernels' launch counts summed over the tools, K1/K2's
    launch shapes, the tools line)."""
    import shutil
    torch.cuda.empty_cache()            # room for the tools' own processes
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    tic = time.perf_counter()
    done = run_tools(tool_runs(TOOLS_DIR), TOOL_LANES)
    for name, (rc, secs, tail) in done.items():
        check(rc == 0, f"(j) {name} exited {rc} after {secs:.0f} s:\n{tail}")

    def load(name):
        return json.loads((TOOLS_DIR / name).read_text())
    out = {"seconds": time.perf_counter() - tic, "lanes": TOOL_LANES,
           "tool_seconds": {k: v[1] for k, v in done.items()}}

    line = [ln for ln in done["bench"][2].splitlines()
            if ln.startswith('{"metric"')]
    check(len(line) == 1, "(j) bench printed no JSON line")
    env = load("bench.json")
    hi, lo = env["high_snr_32dB"], env["low_snr_floor_18dB"]
    check(hi["n_det"] == B and hi["n_ok"] >= 0.99 * B,
          f"(j) bench at 32 dB: {hi['n_ok']} ok, {hi['n_det']} detected")
    out["bench"] = {"pkt_per_s": hi["pkt_per_s"], "ms_32dB":
                    hi["ms_per_batch"], "ms_18dB": lo["ms_per_batch"],
                    "n_ok_32dB": hi["n_ok"], "n_ok_18dB": lo["n_ok"]}

    ref = json.loads(PER_REFERENCE.read_text())["sweeps"]
    for name, f, kind in (("perf_sweep", "per_vht.json", "vht"),
                          ("perf_sweep_lht", "per_lht.json", "lht"),
                          ("perf_sweep_2ss", "per_2ss.json", "2ss"),
                          ("perf_sweep_mu", "per_mu.json", "mu")):
        blob = load(f)
        check(blob["device"] == smi, f"(j) {name} ran on {blob['device']}")
        check_sweep(name, blob, ref[kind])
        out[name] = {k: v["per"] for k, v in blob.items() if k != "device"}
    check(len(out["perf_sweep"]) == 9, "(j) perf_sweep: not VHT MCS0-8")
    check(len(out["perf_sweep_lht"]) == 8,
          "(j) perf_sweep_lht: not L and HT MCS0-3")
    # one MCS at small n: the card's per-row and per-slot results are the
    # CPU's (where the kernels' twins run)
    name = "VHT_mcs4.npz"
    card = np.load(TOOLS_DIR / "tie_card" / name)
    cpu = np.load(TOOLS_DIR / "tie_cpu" / name)
    for k in ("ok", "ltf_idx", "valid", "ok_slot", "digest"):
        check(np.array_equal(card[k], cpu[k]),
              f"(j) perf_sweep card != CPU in {k} (VHT MCS4)")
    out["perf_sweep_card_eq_cpu"] = {"slots": int(card["ok_slot"].size),
                                     "ok": int(card["ok_slot"].sum())}

    pts = load("snr.json")["points"]
    check(all(p["n_det"] == B for p in pts),
          f"(j) bench_snr_sweep: detected {[p['n_det'] for p in pts]}")
    check(pts[0]["launches"]["acs_sweep"] > 0
          and pts[0]["launches"]["traceback_sweep"] > 0,
          f"(j) bench_snr_sweep: K1/K2 did not launch at {pts[0]['snr_db']} "
          f"dB: {pts[0]['launches']}")
    out["bench_snr_sweep"] = [[p["snr_db"], p["n_ok"], p["ms_per_batch"],
                               p["launches"]["acs_sweep"], p["path"]]
                              for p in pts]
    lg = load("long.json")
    check(lg["n_det"] == LONG_B and lg["n_ok"] >= 0.99 * LONG_B,
          f"(j) bench_long: {lg['n_ok']} ok, {lg['n_det']} detected")
    check(pad64(lg["n_trellis"]) == T_LONG, f"(j) bench_long T {lg}")
    out["bench_long"] = {k: lg[k] for k in ("n_trellis", "n_ok", "n_det",
                                            "ms_per_batch", "path")}
    for name, f, tol in (("bench_tx", "tx.json", 2e-6),
                         ("bench_tx_mu", "tx_mu.json", 2e-5)):
        (tx,) = load(f).values()
        check(tx["max_abs_err_vs_gold"] < tol,
              f"(j) {name}: {tx['max_abs_err_vs_gold']} from the gold model")
        out[name] = {"per_s": tx["value"], "ms": tx["ms_per_batch"]}
    mu = load("mu.json")
    check(mu["su2"]["n_ok"] == mu["su2"]["n_det"] == mu["batch"]
          and mu["mu0"]["n_ok"] == mu["mu0"]["n_det"] == mu["batch"],
          f"(j) bench_mu: {mu['su2']}, {mu['mu0']}")
    out["bench_mu"] = {k: mu[k] for k in (
        "su_2x2_vht_mcs7_500B_pkts_per_s", "mu_sta_vht_mcs3_pkts_per_s")}
    dm = load("daemon.json")
    res = dm["resident_block_processing"]
    check(res["ok_per_block"] == res["pkts_per_block"] > 0,
          f"(j) bench_daemon resident: {res}")
    out["bench_daemon"] = {"resident_msps": res["msps"],
                           "max_lossless": dm["max_lossless"] and
                           dm["max_lossless"]["rate_msps"]}
    lat = load("latency.json")
    lost = sum(v["lost"] for v in lat["daemon_rtt"].values())
    check(lost == 0 and all(v["ok"] == v["of"] for v in
                            lat["fused_chain"].values()),
          f"(j) latency_report lost {lost}: {lat}")
    out["latency_report"] = {k: v.get("p50_ms")
                             for k, v in lat["daemon_rtt"].items()}
    mh = load("multihost.json")       # the tool raises on a missed packet
    check([c["n_proc"] for c in mh["curve"]["sp"]] == [1, 2, 4],
          f"(j) multihost_scaling: {mh['curve']}")
    out["multihost_scaling"] = {m: [c.get("ms_per_step_max",
                                          c.get("ms_per_chain_max"))
                                    for c in mh["curve"][m]]
                                for m in ("dp", "sp")}

    launches, shapes = {}, set()
    for f in sorted(TOOLS_DIR.glob("*.json")):
        if f.name not in ("tie_cpu.json",):
            tool_kernels(load(f.name), launches, shapes)
    check(launches["acs_sweep"] > 0 and launches["traceback_sweep"] > 0,
          f"(j) the tools never launched K1/K2: {launches}")
    out["launches"] = launches
    out["card"] = smi
    log(json.dumps({"tools": out}))
    return launches, shapes


def hold_grouped(torch, VK, shapes: set, what: str):
    """``hold_k1_k2`` at each (B, T) of ``shapes`` on random LLRs, the
    shapes of one T in one call.  Returns the max errors."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(71)
    errs = [0.0, 0.0]
    by_t = {}
    for b, t in sorted(shapes):
        by_t.setdefault(t, []).append(b)
    for t, bs in sorted(by_t.items()):
        tic = time.perf_counter()
        llrs = [llr_pairs(torch, rng, dev, b, t - 20) for b in bs]
        e = hold_k1_k2(torch, VK, llrs, f"T={t}, B in {bs} ({what})")
        errs = [max(a, b) for a, b in zip(errs, e)]
        del llrs
        log(f"kernels: held at T={t} in {time.perf_counter() - tic:.2f} s "
            f"({sum(bs)} rows)")
    return errs


def hold_at_path_shapes(torch, VK, paths: dict, held: set):
    """K1/K2 against their twins (``hold_grouped``) at each (B, T) that a
    path launched them at and no earlier phase held them at; ``paths``
    maps a path's name to its set of shapes.  Returns (max errors, the
    sorted [B, T] list of each path)."""
    errs = hold_grouped(torch, VK, set().union(*paths.values()) - held,
                        "the path shapes")
    return errs, {p: [list(bt) for bt in sorted(v)] for p, v in paths.items()}


def ptxas_summary(build_log: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {kernel: {registers, smem_bytes,
    spill_bytes}} (spill stores + loads)."""
    import re
    out, name, spills = {}, None, 0
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the mangled name holds <length><name> of the kernel function
            # (a template's integer argument follows as ILi<value>E)
            sym = m.group(1)
            tail = re.search(r"_kernel(?:ILi(\d+)E)?E", sym)
            end = tail.start() + len("_kernel") if tail else 0
            name = next((sym[end - n: end] for n in range(40, 6, -1)
                         if sym[: end - n].endswith(str(n))), sym)
            if tail and tail.group(1):
                name += f"<{tail.group(1)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name is not None:
            out[name] = {"registers": int(m.group(1)),
                         "smem_bytes": int(m.group(2) or 0),
                         "spill_bytes": spills}
            name, spills = None, 0
    return out


def check_self_contained():
    """Neither JAX nor the JAX package has been imported."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "gr_ieee80211_tpu"))
    check(not bad, f"the port imported {bad[:5]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.models import tx as PTX
    from gr_ieee80211_tpu_torch.ops import cuda_lib as CL
    from gr_ieee80211_tpu_torch.ops import frontend as FE
    from gr_ieee80211_tpu_torch.ops import ofdm as OF
    from gr_ieee80211_tpu_torch.ops import viterbi as V
    from gr_ieee80211_tpu_torch.ops import viterbi_kernels as VK
    from gr_ieee80211_tpu_torch.ops.cplx import CF, from_numpy_cf
    from tools_torch import bench as TB
    check_self_contained()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    _, secs, build_log = CL.build()
    log(f"build: {secs:.1f} s ({len(CL.sources())} sources)")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  {line.strip()}")
    ptxas = ptxas_summary(build_log)
    log(json.dumps({"ptxas": ptxas}))
    check({k.split("<")[0] for k in ptxas} == {
        "acs_kernel", "traceback_kernel", "derotate_kernel",
        "acs_packed_kernel", "traceback_packed_kernel",
        "scan_viterbi_kernel", "payload_chanest_kernel",
        "payload_demod_kernel"},
        f"ptxas did not name the eight package kernels: {sorted(ptxas)}")
    spilled = {k: v for k, v in ptxas.items() if v["spill_bytes"]}
    check(not spilled, f"package kernels spill registers: {spilled}")

    kernels = (phase_kernels(torch, VK)
               + phase_kernels_extra(torch, VK, FE)
               + [phase_scan_viterbi(torch, V),
                  phase_payload_chanest(torch, OF),
                  phase_payload_demod(torch, OF)])
    bench = TB.bench_streams(B)         # bench.py's streams
    launches, chain_ok, chain_res = phase_chain(torch, VK, PRX,
                                                from_numpy_cf, bench)
    phase_reference(torch, PRX, from_numpy_cf, bench)
    engine_launches, engine_timing, engine_shapes = phase_engine(
        torch, PRX, bench, chain_ok)
    phase_engine_reference(torch, PRX)
    tx_launches, tx_su = phase_tx_su(torch, PRX, PTX, CF, bench, smi)
    tx_mu = phase_tx_mu(torch, PTX, from_numpy_cf, smi)
    mu_launches, mu_out, mu_errs, station0 = phase_mu_loop(
        torch, VK, PRX, PTX, CF, from_numpy_cf, smi)
    # engine (b) with speculation, as the streamer's engine runs
    engine_ms = 1e3 * float(np.mean(engine_timing[True])) / N_BLOCKS
    stream_launches, stream_shapes = phase_streaming(torch, PRX,
                                                     engine_ms, smi)
    mesh_launches, mesh_shapes = phase_mesh(
        torch, PRX, CF, from_numpy_cf, bench, chain_res, station0,
        torch.device("cuda", 0), smi)
    tools_launches, tools_shapes = phase_tools(torch, smi)
    # K1/K2 at every shape the engine, the streamer and the sharded
    # programs launched them at (the chain's and the MU path's shapes were
    # held above)
    # and at every shape the tools launched them at, with bench_long's
    # trellis among them (random LLRs at its chunk when it stayed on the
    # algebraic fast path)
    held = {(B, T_KERNEL), (B_BUCKET, T_KERNEL)} | {
        (h["B"], h["T"]) for h in mu_out["mu_k1_k2_held_at"]}
    tool_shapes = set(tools_shapes)
    if not any(t == T_LONG for _, t in tool_shapes):
        tool_shapes.add((128, T_LONG))
    path_errs, held_at = hold_at_path_shapes(
        torch, VK, {"engine": engine_shapes, "stream": stream_shapes,
                    "mesh": mesh_shapes, "tools": tool_shapes}, held)
    check(stream_shapes and engine_shapes and mesh_shapes,
          "no K1/K2 launch shapes recorded on the engine, stream or mesh "
          "path")
    check_self_contained()
    log(json.dumps({"paths": {**tx_su, **tx_mu, **mu_out, "card": smi}}))

    for k in kernels:
        name = k["name"]
        k["on_path"] = name in ("acs_sweep", "traceback_sweep",
                                "scan_viterbi", "payload_chanest",
                                "payload_demod")
        if name in ("acs_sweep", "traceback_sweep"):
            # also held at the MU path's shapes and at every path's
            k["max_abs_err"] = max(k["max_abs_err"],
                                   mu_errs[name == "traceback_sweep"],
                                   path_errs[name == "traceback_sweep"])
            k["held_at_mu"] = mu_out["mu_k1_k2_held_at"]
            k["held_at_engine"] = held_at["engine"]
            k["held_at_stream"] = held_at["stream"]
            k["held_at_mesh"] = held_at["mesh"]
            k["held_at_tools"] = held_at["tools"]
        k["launches_chain"] = launches[name]
        k["launches_engine"] = engine_launches[name]
        k["launches_tx_su"] = tx_launches[name]
        k["launches_mu"] = mu_launches["mu"][name]
        k["launches_mu_lo"] = mu_launches["mu_lo"][name]
        k["launches_stream"] = stream_launches[name]
        k["launches_mesh"] = mesh_launches[name]
        k["launches_tools"] = tools_launches[name]
        k["launches"] = sum(k[f"launches_{p}"] for p in (
            "chain", "engine", "tx_su", "mu", "mu_lo", "stream", "mesh",
            "tools"))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
