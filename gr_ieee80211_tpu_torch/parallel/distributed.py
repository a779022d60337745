"""Multi-process scale-out over ``torch.distributed`` (port of
``gr_ieee80211_tpu.parallel.distributed``).

* every process calls :func:`bootstrap` once, joining one process group
  with ``local_shards`` shards of its own;
* :func:`global_mesh` lists world_size x local_shards shards,
  process-major, so contiguous time shards map to contiguous ranks;
* each process ingests only its own contiguous slice of the stream (or
  of the packet windows) and cuts it into its local shards on its device
  (:func:`distribute_stream`, :func:`distribute_windows`); no process
  holds the whole timeline;
* :func:`rx_chain_multihost` and :func:`payload_decode_multihost` run the
  local functions of :mod:`.mesh` on the local shards.  The halos between
  ranks (the first block's head for the previous rank, the last block's
  tail for the next one, circularly) travel in one ``all_gather``, and
  the counts in one ``all_reduce``, so every rank returns the same
  global counts.

The backend is an explicit argument.  NCCL keeps the halos and counts on
the card.  Gloo does not take CUDA tensors for every operation, so under
Gloo the halos (a few thousand samples) and the counts are staged through
host tensors by :func:`_wire`; all computation stays on the rank's
device.  NCCL refuses two ranks on one card.

Launch recipe (N processes, the same program everywhere)::

    from gr_ieee80211_tpu_torch.parallel import distributed as D
    D.bootstrap("tcp://host0:9876", world_size=N, rank=k, backend="nccl")
    mesh = D.global_mesh()
    blocks = D.distribute_stream(local_iq, mesh)   # this rank's time slice
    chain, _halo = D.rx_chain_multihost(cfg, mesh, mpdu_len=...)
    n_ok, n_det = chain(blocks)

``tools_torch/mesh_worker.py`` is one such process.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models.rx import _data_start
from ..ops.cplx import CF, from_numpy_cf
from ..spec.params import PhyConfig
from . import mesh as M

#: shards per process, as given to :func:`bootstrap` (the process group
#: itself is process-wide state of ``torch.distributed``)
_JOINED: dict = {}


def bootstrap(init_method: str, world_size: int, rank: int,
              backend: str = "nccl", local_shards: int = 1) -> None:
    """Join the process group (``init_method`` such as
    ``"tcp://localhost:9876"``), with ``local_shards`` shards in this
    process.  Call once per process before anything else here."""
    if local_shards < 1:
        raise ValueError(f"local_shards={local_shards}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    _JOINED["local_shards"] = local_shards


def global_mesh(axes: tuple[str, ...] = ("sp",),
                device: str | torch.device = "cuda") -> M.Mesh:
    """Every process's shards as one mesh, process-major; the shards go
    round-robin over the visible devices of ``device``'s type by global
    shard index (with one card a host, all of a rank's shards share
    it)."""
    if "local_shards" not in _JOINED:
        raise RuntimeError("call bootstrap() first")
    devs = M.devices_of(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world * _JOINED["local_shards"]
    return M.Mesh(tuple(devs[g % len(devs)] for g in range(n)), tuple(axes),
                  M.mesh_shape(n, len(axes)), rank=rank, world=world)


def _local_pieces(x: np.ndarray, mesh: M.Mesh) -> list[CF]:
    if len(mesh.shape) != 1:
        raise ValueError("the multi-process programs shard a 1-axis mesh")
    return M._split(from_numpy_cf(np.ascontiguousarray(x), "cpu"),
                    mesh.local_devices)


def distribute_stream(local_iq: np.ndarray, mesh: M.Mesh) -> list[CF]:
    """This process's contiguous time slice (equal length on every rank,
    divisible by its shard count) -> one (n_local,) block per local shard,
    each on its device."""
    return _local_pieces(local_iq, mesh)


def distribute_windows(local_wins: np.ndarray, mesh: M.Mesh) -> list[CF]:
    """This process's (b_local, [nrx,] n_samp) aligned packet windows ->
    one piece per local shard, each on its device."""
    return _local_pieces(local_wins, mesh)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend takes it: Gloo gets a host copy."""
    return t.cpu() if dist.get_backend() == "gloo" else t


def _neighbour_halos(blocks: list[CF], lh: int, halo: int):
    """(the previous rank's last ``lh`` samples, the next rank's first
    ``halo`` samples), circularly, from one all_gather of every rank's
    [head | tail]."""
    first, last = blocks[0], blocks[-1]
    mine = torch.cat([torch.stack([first.re[:halo], first.im[:halo]]),
                      torch.stack([last.re[-lh:].to(first.device),
                                   last.im[-lh:].to(first.device)])], dim=1)
    mine = _wire(mine)
    got = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(got, mine)
    rank, world = dist.get_rank(), dist.get_world_size()
    left, right = got[(rank - 1) % world], got[(rank + 1) % world]
    return (CF(left[0, halo:].to(first.device), left[1, halo:].to(first.device)),
            CF(right[0, :halo].to(last.device), right[1, :halo].to(last.device)))


def _all_sum(*counts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each 0-dim count summed over every rank (one all_reduce), on the
    device of the first."""
    dev = counts[0].device
    v = _wire(torch.stack([c.to(dev) for c in counts]).to(torch.int64))
    dist.all_reduce(v, op=dist.ReduceOp.SUM)
    v = v.to(dev).to(torch.int32)
    return tuple(v[i] for i in range(len(counts)))


def rx_chain_multihost(cfg: PhyConfig, mesh: M.Mesh, mpdu_len: int = 0,
                       max_pkts_per_shard: int = 512):
    """The time-sharded chain of :func:`.mesh.rx_chain_sp` over the
    processes' shards.  Returns (chain, halo); ``chain(blocks)`` takes
    this rank's blocks (:func:`distribute_stream`) and returns the global
    (n_fcs_ok, n_detected), the same on every rank."""
    halo = M.sp_halo(cfg)

    def chain(blocks: list[CF]):
        n_local = blocks[0].shape[0]
        left, right = _neighbour_halos(blocks, M.LH, halo)
        padded = [left, *blocks, right]
        counts = [M._local_chain(cfg, M._extend(padded, j + 1, M.LH, halo),
                                 n_local, mpdu_len, max_pkts_per_shard)
                  for j in range(len(blocks))]
        return _all_sum(M._psum([c[0] for c in counts], blocks[0].device),
                        M._psum([c[1] for c in counts], blocks[0].device))

    return chain, halo


def payload_decode_multihost(cfg: PhyConfig, mesh: M.Mesh, mpdu_len: int = 0,
                             nrx: int = 1):
    """Packet-sharded decode (:func:`.mesh.payload_decode_dp`) over the
    processes' shards.  Returns (step, n_samp); ``step(pieces)`` takes this
    rank's window pieces (:func:`distribute_windows`) and returns (this
    rank's psdu, its fcs_ok, the global ok count)."""
    n_samp = _data_start(cfg) + 80 * cfg.nsym

    def step(pieces: list[CF]):
        outs = [M._local_decode(cfg, mpdu_len, p) for p in pieces]
        dev = pieces[0].device
        (total,) = _all_sum(M._psum([o[2] for o in outs], dev))
        return (torch.cat([o[0].to(dev) for o in outs]),
                torch.cat([o[1].to(dev) for o in outs]), total)

    return step, n_samp
