"""The cell at a size a CPU test run holds: three blocks of 32768 owned
samples, NDPs more often, on the CPU."""
import copy

from benchmark.run import load_cell

CELL = "daemon_mixed_30dB"


def small_cell(ndp_share: float = 0.2):
    bench, w, cfg, tr = load_cell(CELL)
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    cfg["blocks"].update(owned_samples=1 << 15, halo_samples=8192)
    tr["layout"]["n_blocks"] = 3
    tr["packets"]["ndp_share"] = ndp_share
    return bench, w, cfg, tr
