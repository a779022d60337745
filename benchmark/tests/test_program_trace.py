"""The readers of the program's own counters and spans
(``benchmark/program_trace.py``): nothing where nothing was traced, a
number after a traced run of the cell at its small size on the CPU."""
import pytest

from benchmark import program_trace as P
from benchmark.run import ROOT, cell_metrics, load_cell, reader, run_cell
from cell_small import CELL, small_cell

NEW = ("host_syncs_per_block", "sync_wait_ms_per_block",
       "bucket_rows_per_call", "fastpath_miss_rows_pct")
SEED = 2**31 + 77


class _Device:
    """A profiled stretch's trace with no range in it."""
    _ranges: list = []


class _T:
    def __init__(self, device):
        self.device = device


def test_the_readers_are_the_cells():
    bench, _, _, _ = load_cell(CELL)
    names = [m["name"] for m in cell_metrics(bench, CELL, "per_layer")]
    assert set(NEW) <= set(names)
    assert (ROOT / "benchmark" / "program_trace.py").exists()


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_nothing(name, monkeypatch):
    r = reader(name)
    assert r.SPANS == ()
    assert r.read(_T(None)) is None
    # a trace with no range, and no block counted since the baseline
    monkeypatch.setattr(P, "BASE", P.trace.snapshot())
    assert r.read(_T(_Device())) is None
    # a program without the tracing module
    monkeypatch.setattr(P, "trace", None)
    assert r.read(_T(_Device())) is None


def test_a_traced_run_reads_the_programs_numbers(monkeypatch):
    import torch
    # the run synchronizes a card around its stretches; there is none here
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    bench, w, cfg, tr = small_cell()
    r = run_cell(bench, w, cfg, tr, SEED, 0.2, 1, device="cpu")
    assert r["correct"], r["checks"]
    m = r["metrics"]
    for name in NEW:
        assert name in m, name
        assert m[name]["value"] >= 0
    assert m["host_syncs_per_block"]["value"] > 5
    assert m["bucket_rows_per_call"]["value"] >= 1
    assert m["fastpath_miss_rows_pct"]["value"] <= 100
    assert m["sync_wait_ms_per_block"]["value"] > 0
