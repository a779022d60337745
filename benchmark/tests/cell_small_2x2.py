"""The two-antenna cell at a size a CPU test run holds: three blocks of
32768 owned samples, NDPs more often, on the CPU."""
import copy

from benchmark.run import load_cell

CELL = "daemon_2x2_mixed_30dB"


def small_cell(ndp_share: float = 0.2, n_blocks: int = 3):
    bench, w, cfg, tr = load_cell(CELL)
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    cfg["blocks"].update(owned_samples=1 << 15, halo_samples=8192)
    tr["layout"]["n_blocks"] = n_blocks
    tr["packets"]["ndp_share"] = ndp_share
    return bench, w, cfg, tr
