"""Entry points: the flagship decode step on one device and a dry run of
every sharded program (port of the repository's ``__graft_entry__.py``).

    python3 -m gr_ieee80211_tpu_torch.entry [N_SHARDS]    # on the card
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .gold import channel as chn
from .gold import mac, sounding, tx
from .models import rx as RX
from .ops.cplx import from_numpy_cf
from .parallel import mesh as M
from .spec.params import Fmt, MuConfig, PhyConfig


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): the batched VHT MCS7 520 B payload demod +
    decode core (``models.rx._payload_core``) on B = 8 windows of a
    seeded noise stream; ``fn(*args)`` returns the (8, psdu_len) uint8
    PSDUs.  Raises for ``"cuda"`` where there is no card."""
    dev = M.devices_of(device)[0]
    cfg = PhyConfig(Fmt.VHT, 7, 1, 520, ampdu=True)
    n = RX._data_start(cfg) + 80 * cfg.nsym
    B = 8
    rng = np.random.default_rng(0)
    stream = from_numpy_cf(
        (rng.normal(size=(1, n + 256)) + 1j * rng.normal(size=(1, n + 256))
         ).astype(np.complex64), dev)
    ltf_idx = torch.from_numpy(np.linspace(0, 128, B).astype(np.int32)).to(dev)
    cfo = torch.zeros(B, dtype=torch.float32, device=dev)

    def fn(stream, ltf_idx, cfo):
        return RX._payload_core(cfg, stream, ltf_idx, cfo, nrx=1)["psdu"]

    return fn, (stream, ltf_idx, cfo)


def dryrun_multichip(n_shards: int, device: str | torch.device = "cuda"):
    """Every sharded program on an ``n_shards`` mesh: dp payload decode,
    sp detection with halo exchange, the sp chain, dp 2x2 decode and the
    dp MU-STA chain, each held to its expected count; prints one line."""
    dev = M.devices_of(device)[0]
    rng = np.random.default_rng(0)

    # --- dp: packet-sharded decode -----------------------------------------
    mesh = M.make_mesh(n_shards, axes=("dp",), device=device)
    mpdu = mac.qos_data_frame(b"x" * 40, "02:00:00:00:00:01",
                              "02:00:00:00:00:02", "02:00:00:00:00:01", 1)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 2, 1, len(am), ampdu=True)
    wave = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    step, n_samp = M.payload_decode_dp(cfg, mesh, mpdu_len=len(mpdu))
    B = 2 * n_shards
    # t = 0 at the L-LTF1 symbol (STF 0..160, GI2 160..192, LTF1 at 192),
    # 4 samples early into GI2 as a real sync would be
    wins = np.tile(wave[188: 188 + n_samp][None], (B, 1)).astype(np.complex64)
    _, _, total = step(from_numpy_cf(wins, dev))
    total = int(total)
    _check(total == B, f"dp decode: {total}/{B} packets passed FCS")

    # --- sp: time-sharded front end with halo exchange ---------------------
    mesh2 = M.make_mesh(n_shards, axes=("sp",), device=device)
    det = M.frontend_sp(mesh2, max_out_per_shard=64)
    gap = 3000
    stream = np.zeros(n_shards * 8192, np.complex64)
    pos, placed = 2048, []
    while pos + len(wave) < len(stream) - 1024:
        stream[pos: pos + len(wave)] += wave.astype(np.complex64)
        placed.append(pos)
        pos += len(wave) + gap
    cand = det(from_numpy_cf(stream, dev)).cpu().numpy()
    # after clustering (the non-legacy STF re-fires the lag-16 detector
    # mid-packet), exactly one trigger per packet; noise-free plateaus fire
    # up to ~64 samples early, never late
    trigs = RX.dedup_triggers(np.sort(cand[cand >= 0]))
    _check(len(trigs) == len(placed),
           f"sp front end: {len(trigs)} triggers for {len(placed)} packets")
    err = np.asarray(trigs) - np.asarray(placed)
    _check(bool((err >= -64).all() and (err <= 8).all()),
           f"sp trigger offsets outside [-64, 8]: {err.tolist()}")

    # --- sp: the whole time-sharded chain ----------------------------------
    n_pkt = 2 * n_shards
    spacing = len(wave) + 1400
    stream2 = np.zeros(-(-(n_pkt * spacing + 4096) // n_shards) * n_shards,
                       np.complex64)
    for i in range(n_pkt):
        stream2[1000 + i * spacing: 1000 + i * spacing + len(wave)] = wave
    chain, _ = M.rx_chain_sp(cfg, mesh2, mpdu_len=len(mpdu),
                             max_pkts_per_shard=max(8, n_pkt))
    n_ok, _ = (int(x) for x in chain(from_numpy_cf(stream2, dev)))
    _check(n_ok == n_pkt, f"sp chain: {n_ok}/{n_pkt} packets passed FCS")

    # --- dp 2x2: SU-MIMO windows through the ZF role -----------------------
    cfg2 = PhyConfig(Fmt.VHT, 2, 2, len(am), ampdu=True)
    wave2 = tx.tx_waveform(cfg2, am, group_id=0, partial_aid=0)
    h2 = (np.eye(2) + 0.25 * (rng.normal(size=(2, 2))
                              + 1j * rng.normal(size=(2, 2))))
    mixed = h2 @ wave2
    step2, n_samp2 = M.payload_decode_dp(cfg2, mesh, mpdu_len=len(mpdu),
                                         nrx=2)
    wins2 = np.tile(mixed[:, 188: 188 + n_samp2][None], (B, 1, 1)
                    ).astype(np.complex64)
    _, _, total2 = step2(from_numpy_cf(wins2, dev))
    total2 = int(total2)
    _check(total2 == B, f"dp 2x2 decode: {total2}/{B} packets passed FCS")

    # --- dp MU-STA: detect -> SIG-B -> the user's payload per shard --------
    h_sta = [(rng.normal(size=(1, 2)) + 1j * rng.normal(size=(1, 2)))
             / np.sqrt(2) for _ in range(2)]
    am1 = mac.ampdu_aggregate_vht([mac.qos_data_frame(
        b"u1" * 12, "02:00:00:00:00:11", "02:00:00:00:00:01",
        "02:00:00:00:00:11", 2)])
    mu = MuConfig((PhyConfig(Fmt.VHT, 2, 1, len(am), ampdu=True),
                   PhyConfig(Fmt.VHT, 1, 1, len(am1), ampdu=True)),
                  group_id=2)
    h_rows = np.repeat(np.stack(h_sta)[:, 0][:, :, None], 56, axis=2)
    q = sounding.q_to_grid(sounding.zf_q(h_rows))
    wave_mu = tx.tx_waveform_mu(mu, [am, am1], q)
    burst = chn.mimo_channel(wave_mu, h_sta[0])[0]
    one = np.zeros(6144, np.complex64)
    one[512: 512 + len(burst)] = burst.astype(np.complex64)
    streams_mu = np.tile(one[None], (n_shards, 1))
    u0 = mu.users[0]
    cfg_mu = PhyConfig(Fmt.VHT, u0.mcs, 1, u0.psdu_len, ampdu=True,
                       mu_nsym=mu.nsym)
    mu_chain = M.mu_chain_dp(cfg_mu, mesh, n_total=2, own=0,
                             mpdu_len=len(mpdu))
    mu_ok, _ = (int(x) for x in mu_chain(from_numpy_cf(streams_mu, dev)))
    _check(mu_ok == n_shards,
           f"dp MU chain: {mu_ok}/{n_shards} packets passed SIG-B+FCS")
    print(f"dryrun ok: dp decoded {total}/{B}, sp detected {len(trigs)}/"
          f"{len(placed)} packets, sp chain decoded {n_ok}/{n_pkt}, "
          f"dp 2x2 decoded {total2}/{B}, dp MU decoded {mu_ok}/{n_shards}")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else len(M.devices_of("cuda")))
