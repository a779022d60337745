"""The port's multi-process scale-out (``parallel/distributed.py``) on
the CPU: 2 ranks over Gloo through ``tools_torch/mesh_worker.py``, 4
local shards each, each rank ingesting only its half of the input.

The time-sharded chain's counts equal the port's single-process 8-shard
result on the same stream, on both ranks (the counts are summed over the
ranks and replicated); the packet-sharded decode decodes every window.
The single-process result is held to the JAX package by
``tests/test_torch_mesh.py``, so no JAX runs here."""
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tools_torch" / "mesh_worker.py"

torch.set_num_threads(2)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(mode, *extra):
    """Two ranks of the worker on the CPU; returns each rank's
    ((n_ok, n_det), launches)."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), "2", str(port), mode,
         "--local-shards", "4", "--backend", "gloo", "--device", "cpu",
         "--reps", "1", *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=240)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                pytest.fail(f"mesh worker timed out:\n{p.communicate()[0][-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}"
        m = re.search(r"RESULT ok=(\d+) det=(\d+)", out)
        t = re.search(rf"{mode.upper()}TIME ms=[0-9.]+", out)
        n = re.search(r"LAUNCHES (\{.*\})", out)
        assert m and t and n, f"worker output incomplete:\n{out[-2000:]}"
        res.append(((int(m.group(1)), int(m.group(2))),
                    json.loads(n.group(1))))
    return res


def test_two_process_chain_matches_single_process():
    sys.path.insert(0, str(ROOT))
    from tools_torch.mesh_worker import build_stream
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
    from gr_ieee80211_tpu_torch.parallel import mesh as PM
    cfg, ml, stream = build_stream()
    chain, _ = PM.rx_chain_sp(cfg, PM.make_mesh(8, axes=("sp",),
                                                device="cpu"),
                              mpdu_len=ml, max_pkts_per_shard=16)
    ref = tuple(int(x) for x in chain(from_numpy_cf(stream, "cpu")))
    assert ref == (16, 16)
    res = _run_workers("sp", "--max-pkts", "16")
    assert res[0][0] == res[1][0] == ref, f"{res} != {ref}"
    # on the CPU the kernels' twins run: no launch is counted
    assert not any(v for _, ln in res for v in ln.values())


def test_two_process_dp_decodes_every_window():
    res = _run_workers("dp", "--b-local", "8")
    assert res[0][0] == res[1][0] == (16, 16)


def test_global_mesh_and_ingest():
    """One rank of a Gloo group: the global mesh lists its local shards
    process-major, the defaults need the card, and each rank's slice is
    cut into its shards."""
    import numpy as np
    import torch.distributed as dist
    from gr_ieee80211_tpu_torch.parallel import distributed as D
    D.bootstrap(f"tcp://127.0.0.1:{_free_port()}", 1, 0, backend="gloo",
                local_shards=3)
    try:
        mesh = D.global_mesh(device="cpu")
        assert mesh.shape == (3,) and mesh.world == 1 and mesh.rank == 0
        assert len(mesh.local_devices) == 3
        x = (np.arange(12) + 1j * np.arange(12)).astype(np.complex64)
        blocks = D.distribute_stream(x, mesh)
        assert [b.re.tolist() for b in blocks] == [
            [0.0, 1, 2, 3], [4.0, 5, 6, 7], [8.0, 9, 10, 11]]
        with pytest.raises(ValueError):
            D.distribute_windows(x[:10], mesh)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="needs a CUDA card"):
                D.global_mesh()
    finally:
        dist.destroy_process_group()
