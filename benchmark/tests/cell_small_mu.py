"""The MU station's cell at a size a CPU test run holds: three blocks of
32768 owned samples, on the CPU.  The mix keeps its kinds of packet, with
more NDPs (sounding rounds), foreign and SU packets than the cell's, each
MU user and SU packet carries at most 600 B (so MCS 0 fits a block), and
its ``shape_seed`` is one whose three blocks hold every kind: 11 MU PPDUs
of the station's group, 2 of the other group, 2 NDPs, 2 SU packets."""
import copy

from benchmark.run import load_cell

CELL = "daemon_mu_sta_30dB"
SHAPE_SEED = 20261057


def small_cell():
    bench, w, cfg, tr = load_cell(CELL)
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    cfg["blocks"].update(owned_samples=1 << 15, halo_samples=8192)
    p = tr["packets"]
    tr["shape_seed"] = SHAPE_SEED
    tr["layout"]["n_blocks"] = 3
    p["kinds"] = {"mu_own": 0.5, "mu_foreign": 0.15, "ndp": 0.15, "su": 0.2}
    p["mu"]["payload_bytes"][1] = 600
    p["su"]["payload_bytes"][1] = 600
    return bench, w, cfg, tr
