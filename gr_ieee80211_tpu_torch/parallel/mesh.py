"""Device-mesh scale-out of the receive programs (port of
``gr_ieee80211_tpu.parallel.mesh``).

Two parallel axes exist in the workload:

* ``dp``: packet-batch parallelism.  Aligned packet windows (or whole
  captures, for the MU station) are cut into shards, each shard runs the
  same demod + decode program, and only the counters are summed;
* ``sp``: sample-stream (time) parallelism.  The IQ timeline is cut into
  contiguous blocks; each block is extended by a halo taken from its
  right neighbour (and, for the chain, a left context from its left
  neighbour), circularly, so the sliding correlators see across block
  boundaries (overlap-save).

The reference runs one local function per device under ``shard_map``;
PyTorch has none, so the port says the same thing plainly.  A
:class:`Mesh` lists one device per shard.  Each program cuts its input
into per-shard pieces on those devices and runs a module-level local
function (``_local_decode``, ``_local_fe``, ``_local_chain``,
``_local_mu``) on each piece, one shard after another.  The reference's
``ppermute`` becomes slicing of the neighbouring shard and a copy to
this shard's device (:func:`_extend`); its ``psum`` becomes a sum of the
shards' 0-dim counts on the first shard's device.  Each shard is its own
program, as in the reference: what reads the batch (the dd gate's SNR,
``segmented_pays``, the decode tier, the detector's power floor) is
decided per shard.  :mod:`.distributed` runs the same local functions
across processes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import rx as RX
from ..ops import crc as CRC
from ..ops import frontend as FE
from ..ops import ofdm as OF
from ..ops import viterbi as V
from ..ops.cplx import CF, csum, expj
from ..spec.params import Fmt, PhyConfig


def devices_of(device: str | torch.device = "cuda") -> list[torch.device]:
    """The visible devices of ``device``'s type: every CUDA card, or the
    CPU.  Raises for ``"cuda"`` where there is no card."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' needs a CUDA card; pass "
                           "device='cpu' to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_shape(n: int, n_axes: int) -> tuple[int, ...]:
    """The reference's mesh shapes: (n,), or (a, n // a) with a the
    largest divisor of n not above sqrt(n)."""
    if n_axes == 1:
        return (n,)
    if n_axes != 2:
        raise ValueError(f"a mesh has 1 or 2 axes, not {n_axes}")
    a = int(np.sqrt(n))
    while n % a:
        a -= 1
    return (a, n // a)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shards of the sharded programs.

    ``devices`` holds one device per shard, process-major, for the whole
    mesh of ``shape`` over ``axis_names``; ``rank`` and ``world`` name
    this process among the processes that share the mesh
    (:func:`.distributed.global_mesh`).  Several shards may share one
    device: they then run on it one after another."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int = 0
    world: int = 1

    @property
    def shards(self) -> tuple[torch.device, ...]:
        """The devices a single-process program shards over: one row of
        the last axis.  The rows of a 2-axis mesh are replicas, which
        compute the same values, so one row runs."""
        if self.world != 1:
            raise ValueError("a mesh of several processes runs through "
                             "parallel.distributed")
        return self.devices[: self.shape[-1]]

    @property
    def local_devices(self) -> tuple[torch.device, ...]:
        """The devices of this process's shards."""
        k = len(self.devices) // self.world
        return self.devices[self.rank * k: (self.rank + 1) * k]


def make_mesh(n_devices: int | None = None, axes=("dp",),
              device: str | torch.device = "cuda") -> Mesh:
    """A mesh of ``n_devices`` shards (default: one per visible card),
    placed round-robin over the visible devices of ``device``'s type; on
    one card every shard shares it."""
    devs = devices_of(device)
    n = n_devices or len(devs)
    return Mesh(tuple(devs[i % len(devs)] for i in range(n)), tuple(axes),
                mesh_shape(n, len(axes)))


def _split(x: CF, devices) -> list[CF]:
    """x cut along its first axis into one equal piece per device, each
    piece on its device."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} shards")
    k = x.shape[0] // n
    return [CF(x.re[i * k: (i + 1) * k].to(d), x.im[i * k: (i + 1) * k].to(d))
            for i, d in enumerate(devices)]


def _extend(blocks: list[CF], i: int, lh: int, halo: int) -> CF:
    """Block ``i`` with the last ``lh`` samples of block ``i - 1`` before
    it and the first ``halo`` samples of block ``i + 1`` after it, on
    block ``i``'s device; the neighbours wrap around the list (the
    reference's circular ``ppermute``)."""
    n_local = blocks[i].shape[0]
    if halo > n_local or lh > n_local:
        raise ValueError(f"a halo of {halo} (left {lh}) needs blocks of at "
                         f"least that many samples, not {n_local}")
    parts = [blocks[i - 1][-lh:]] if lh else []
    parts += [blocks[i], blocks[(i + 1) % len(blocks)][:halo]]
    dev = blocks[i].device
    return CF(torch.cat([p.re.to(dev) for p in parts]),
              torch.cat([p.im.to(dev) for p in parts]))


def _psum(counts: list[torch.Tensor], device) -> torch.Tensor:
    """The sum of the shards' 0-dim counts, on ``device``."""
    return torch.stack([c.to(device) for c in counts]).sum().to(torch.int32)


# ---------------------------------------------------------------------------
# dp: packet-sharded payload decode
# ---------------------------------------------------------------------------

def _local_decode(cfg: PhyConfig, mpdu_len: int, xs: CF):
    """One shard of :func:`payload_decode_dp`: (b, [nrx,] n_samp) windows
    with t = 0 at the L-LTF -> (psdu (b, psdu_len) uint8, fcs ok (b,),
    ok count).  The fine CFO comes from antenna 0's LTF lag-64
    autocorrelation and is applied as one direct phasor per sample;
    channel estimation without refinement; the demodulation
    (:func:`ops.ofdm.payload_demod`); the scan Viterbi."""
    if xs.ndim == 2:
        xs = CF(xs.re[:, None], xs.im[:, None])
    b, _, n_samp = xs.shape
    dev = xs.device
    cfo = FE.fine_cfo_batch(xs[:, 0, :128],
                            torch.zeros(b, dtype=torch.float32, device=dev))
    t = torch.arange(n_samp, dtype=torch.float32, device=dev)
    xs = xs * expj(FE.NEG_TWO_PI * cfo[:, None, None] / FE.FS
                   * t[None, None, :])
    pidx = OF._idx("PILOT_IDX", dev)
    if cfg.fmt == Fmt.L:
        h0 = OF.legacy_chanest(xs[:, 0], 0)
        h = h0[:, None, None, :]
        pilot_h = h0[:, pidx][:, None, :]
    else:
        h, pilot_h = OF.nl_chanest(xs, 208 + 160 + 80, cfg.nltf, cfg.nss)
        if cfg.fmt == Fmt.HT:
            pilot_h = csum(h[:, :, :, pidx], dim=2)
    coded = OF.payload_demod(xs, RX._data_start(cfg), h, pilot_h, cfg)
    bits = V.viterbi_decode(V.depuncture(coded, cfg.cr, cfg.n_trellis))
    data = OF.descramble_bits(bits)
    psdu_bits = data[:, 16: 16 + 8 * cfg.psdu_len]
    if cfg.fmt == Fmt.VHT and mpdu_len > 4:
        ok = CRC.fcs_ok_batch(psdu_bits[:, 32: 32 + 8 * mpdu_len],
                              8 * mpdu_len)
    elif cfg.fmt != Fmt.VHT and cfg.psdu_len > 4:
        ok = CRC.fcs_ok_batch(psdu_bits, 8 * cfg.psdu_len)
    else:
        ok = torch.zeros(b, dtype=torch.bool, device=dev)
    return OF.bits_to_bytes_batch(psdu_bits), ok, ok.sum().to(torch.int32)


def payload_decode_dp(cfg: PhyConfig, mesh: Mesh, mpdu_len: int = 0,
                      nrx: int = 1):
    """Build a packet-sharded decode step.

    Returns (step, n_samp).  ``step(wins)`` takes aligned windows (B,
    n_samp), or (B, nrx, n_samp) for nrx > 1 (the 2x2 ZF role), with B
    divisible by the shard count and t = 0 at the L-LTF window, and
    returns (psdu (B, psdu_len) uint8, fcs_ok (B,), the global ok count),
    all on the first shard's device.  Like the reference it decodes with
    the scan Viterbi (``ops.viterbi.viterbi_decode``): on the card the
    demodulation is one launch of K8 (``ops.ofdm.payload_demod``) and the
    decode one of K6 a shard.  ``nrx`` names the windows' antenna count
    (their shape carries it)."""
    n_samp = RX._data_start(cfg) + 80 * cfg.nsym
    devs = mesh.shards

    def step(wins: CF):
        outs = [_local_decode(cfg, mpdu_len, xs)
                for xs in _split(wins, devs)]
        return (torch.cat([o[0].to(devs[0]) for o in outs]),
                torch.cat([o[1].to(devs[0]) for o in outs]),
                _psum([o[2] for o in outs], devs[0]))

    return step, n_samp


# ---------------------------------------------------------------------------
# sp: time-sharded front end with halo exchange
# ---------------------------------------------------------------------------

#: >= the preamble + SIG span the correlators need across a boundary
HALO = 512


def _local_fe(ext: CF, n_local: int, shard: int, max_out: int):
    """One shard of :func:`frontend_sp`: plateau starts of the per-sample
    STF metric over block + halo that fall inside the block, as global
    sample indices (padded -1)."""
    m, _ = FE.stf_metrics(ext)
    # the per-sample twin of detect_plateaus_strided's refire rejection:
    # real L-STF plateaus span ~160 samples, mid-packet STF refires ~70
    cand = FE.detect_plateaus(m, max_out=max_out, confirm=(128, 96))
    return torch.where((cand >= 0) & (cand < n_local),
                       cand + shard * n_local, -1)


def frontend_sp(mesh: Mesh, max_out_per_shard: int = 512):
    """Build a time-sharded detector: ``det(stream)`` takes an (N,) IQ
    stream, N divisible by the shard count; each shard extends its block
    by the right neighbour's first HALO samples and reports (n_shards,
    max_out_per_shard) int32 global candidate indices, padded -1, on the
    first shard's device."""
    devs = mesh.shards

    def det(stream: CF) -> torch.Tensor:
        blocks = _split(stream, devs)
        n_local = blocks[0].shape[0]
        return torch.stack([
            _local_fe(_extend(blocks, i, 0, HALO), n_local, i,
                      max_out_per_shard).to(devs[0])
            for i in range(len(blocks))])

    return det


# ---------------------------------------------------------------------------
# sp: the whole receive chain, time-sharded
# ---------------------------------------------------------------------------

#: left context: correlator history so that a plateau straddling a block
#: boundary is not detected again as a fresh edge by the right shard
LH = 256


def sp_halo(cfg: PhyConfig) -> int:
    """The right halo of :func:`rx_chain_sp`: a packet's span past its
    LTF plus the trigger -> LTF slack."""
    return RX._data_start(cfg) + 80 * cfg.nsym + 700


def _local_chain(cfg: PhyConfig, ext: CF, n_local: int, mpdu_len: int,
                 max_pkts: int):
    """One shard of :func:`rx_chain_sp` on its extended block (LH of left
    context, the block, the halo): detect -> dedup -> sync -> decode of the
    packets whose trigger falls inside the block.  Returns (n_ok, n_det)
    as 0-dim int32 tensors."""
    n_need = RX._data_start(cfg) + 80 * cfg.nsym
    n = ext.shape[-1]
    m4 = FE.stf_metric_strided(ext)
    cand = FE.detect_plateaus_strided(m4, max_out=3 * max_pkts)
    # ownership: a packet belongs to the shard holding its trigger (the
    # halos' candidates are the neighbours'); applied before dedup, whose
    # -1 holes the reference keeps
    cand = torch.where((cand >= LH) & (cand < LH + n_local), cand, -1)
    trigs = FE.dedup_triggers_device(cand, max_pkts,
                                     spacing=RX.TRIG_DEDUP_SPACING)
    valid = trigs >= 0
    ltf_idx, peak, cfo, _ = RX._sync_core(ext, torch.clamp(trigs, min=0))
    valid = valid & (peak > 0.5) & (ltf_idx + n_need < n)
    ltf_idx = torch.clamp(ltf_idx, 0, n - n_need - 1)
    out = RX._payload_core(cfg, CF(ext.re[None], ext.im[None]), ltf_idx, cfo,
                           nrx=1, mpdu_len=mpdu_len)
    ok = RX._ok_flags(out)
    return (ok & valid).sum().to(torch.int32), valid.sum().to(torch.int32)


def rx_chain_sp(cfg: PhyConfig, mesh: Mesh, mpdu_len: int = 0,
                max_pkts_per_shard: int = 512):
    """Build the detect -> sync -> decode -> count chain, time-sharded.

    Returns (chain, halo).  ``chain(stream)`` takes an (N,) IQ stream, N
    divisible by the shard count; each shard runs the chain on its block
    with LH samples of the left neighbour's tail before it and ``halo``
    of the right neighbour's head after it, owns exactly the packets
    whose trigger falls inside its block, and the global (n_fcs_ok,
    n_detected) are summed on the first shard's device."""
    halo = sp_halo(cfg)
    devs = mesh.shards

    def chain(stream: CF):
        blocks = _split(stream, devs)
        n_local = blocks[0].shape[0]
        counts = [_local_chain(cfg, _extend(blocks, i, LH, halo), n_local,
                               mpdu_len, max_pkts_per_shard)
                  for i in range(len(blocks))]
        return (_psum([c[0] for c in counts], devs[0]),
                _psum([c[1] for c in counts], devs[0]))

    return chain, halo


# ---------------------------------------------------------------------------
# dp: the MU-STA chain, one capture per shard
# ---------------------------------------------------------------------------

def _local_mu(cfg: PhyConfig, streams: CF, n_total: int, own: int,
              mpdu_len: int, max_pkts: int):
    """One shard of :func:`mu_chain_dp`: its rows, end to end as one
    capture, through ``models.rx.rx_chain_count_mu``."""
    return RX.rx_chain_count_mu(cfg, streams.reshape(1, -1), n_total=n_total,
                                own=own, nrx=1, mpdu_len=mpdu_len,
                                max_pkts=max_pkts)


def mu_chain_dp(cfg: PhyConfig, mesh: Mesh, n_total: int, own: int,
                mpdu_len: int = 0, max_pkts_per_shard: int = 16):
    """Build a dp-sharded MU-STA chain: ``chain(streams)`` takes (n_shards,
    L) captures, one a shard, runs detect -> SIG-B -> the user's payload on
    each, and sums the (n_ok, n_det) counts on the first shard's device."""
    devs = mesh.shards

    def chain(streams: CF):
        counts = [_local_mu(cfg, s, n_total, own, mpdu_len,
                            max_pkts_per_shard)
                  for s in _split(streams, devs)]
        return (_psum([c[0] for c in counts], devs[0]),
                _psum([c[1] for c in counts], devs[0]))

    return chain
