#!/usr/bin/env python3
"""How the rows a call decodes past its packets move the count of the
chain, one device and time-sharded, on the bench's 18 dB stream.

    python3 tools_torch/mesh_rows.py [MARGIN ...]      # default 0 1 64

Each shard of ``parallel.mesh.rx_chain_sp`` decodes ``max_pkts_per_shard``
rows, the packets its block owns and, past them, rows whose trigger is
a -1 hole (clamped to sample 0).  For each MARGIN this prints one JSON
line with (n_ok, n_det) and the decode path (``record=``) of
``models.rx.rx_chain_count`` with ``max_pkts`` = B + 4 * MARGIN, and
(n_ok, n_det) of ``rx_chain_sp`` on 4 shards with ``max_pkts_per_shard``
= B / 4 + MARGIN (at least the 1025 packets the fullest shard owns),
with the decision-directed channel pass's gate (``models.rx._dd_gate``)
as each shard's ``_payload_core`` took it.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_rows: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as CS
    from gr_ieee80211_tpu_torch.models import rx as PRX
    from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
    from gr_ieee80211_tpu_torch.parallel import mesh as M
    margins = [int(a) for a in argv] or [0, 1, 64]
    cfg, mpdu, _, _, streams = CS.bench_streams()
    dev = torch.device("cuda", 0)
    st = from_numpy_cf(streams[CS.SNR_LO], dev)
    st1 = from_numpy_cf(streams[CS.SNR_LO][None], dev)
    mesh = M.make_mesh(4, axes=("sp",))
    gates = []
    dd_gate = PRX._dd_gate

    def recorded_gate(xs, c):
        gates.append(dd_gate(xs, c))
        return gates[-1]

    PRX._dd_gate = recorded_gate
    for m in margins:
        rec = []
        one = [int(x) for x in PRX.rx_chain_count(
            cfg, st1, mpdu_len=len(mpdu), max_pkts=CS.B + 4 * m, record=rec)]
        line = {"margin": m, "single": one, "single_path": rec}
        if CS.B // 4 + m >= 1025:
            chain, _ = M.rx_chain_sp(cfg, mesh, mpdu_len=len(mpdu),
                                     max_pkts_per_shard=CS.B // 4 + m)
            gates.clear()
            line["sp"] = [int(x) for x in chain(st)]
            line["sp_dd_gate"] = list(gates)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
