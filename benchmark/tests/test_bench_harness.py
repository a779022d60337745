"""The harness's own pieces on the CPU: names resolve, the generator
repeats, the frozen reference syncs and estimates what the generator
sends, the import guard, the refusal without a card, the trace arithmetic."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import core, generate
from benchmark.entries import rx_engine_blocks as E
from benchmark.metrics import viterbi_roofline
from benchmark.run import ROOT, cell_metrics, load_cell, reader
from cell_small import CELL, small_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
              "0123456789_.-")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert 1 <= len(n) <= 64 and set(n) <= NAME_OK and n[0] not in ".-"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    bench, w, cfg, tr = load_cell(cell)
    assert cfg["name"] == w["config"]
    assert tr["layout"]["kind"] == "blocks"
    entry = __import__(f"benchmark.entries.{cfg['entry']}",
                       fromlist=["Run"])
    assert callable(entry.Run) and callable(entry.check) and cfg["limits"]
    for m in cell_metrics(bench, cell, "per_layer"):
        r = reader(m["name"])
        assert callable(r.read)
        for t in r.SPANS:
            owner, name = core.resolve(t)
            assert callable(getattr(owner, name)), t
    for m in cell_metrics(bench, cell, "end_to_end"):
        assert m["name"] == "setup_s" or m["name"] in {
            "msamples_per_s", "block_ms_p90"}


def test_generator_repeats_from_a_seed():
    _, _, cfg, tr = small_cell()
    with core.workers(2) as pool:
        a = generate.make(tr, cfg, 2**31 + 7, pool)
        b = generate.make(tr, cfg, 2**31 + 7, pool)
        c = generate.make(tr, cfg, 2**31 + 8, pool)
    for va, vb in zip(a["views"], b["views"]):
        assert np.array_equal(va, vb)
    assert a["sent"] == b["sent"]
    assert not np.array_equal(a["views"][0], c["views"][0])
    # another seed orders and fills the same packets: the same work
    for sa, sc in zip(a["sent"], c["sent"]):
        key = lambda f: (f["fmt"], f["mcs"], f["is_ndp"],
                         tuple(len(m) for m in f["mpdus"]))
        assert sorted(map(key, (f for _, f in sa))) == \
            sorted(map(key, (f for _, f in sc)))


def test_block_layout_keeps_packets_owned():
    _, _, cfg, tr = small_cell()
    geo = cfg["blocks"]
    B, H, L = (geo["owned_samples"], geo["halo_samples"],
               geo["left_context_samples"])
    with core.workers(2) as pool:
        inp = generate.make(tr, cfg, 5, pool)
    for k, sent in enumerate(inp["sent"]):
        assert inp["views"][k].shape == (1, L + B + H)
        for start, f in sent:
            assert L + 300 <= start < L + B - generate.OWN_MARGIN
    full = generate.block_shapes(tr, geo)
    spec = full[0]["inner"][0][0]
    wave, _ = generate.synth((spec, [bytes(spec[2] // spec[3])] * spec[3],
                             [1, 0]))
    assert wave.shape[-1] == generate.spec_cfg(spec).n_samples


def test_reference_syncs_and_estimates_an_ndp():
    """The frozen receiver's own sync finds each NDP the generator sent;
    at the nominal L-LTF index the estimate shows the gains of the
    generator's 1 x 2 channel on every occupied non-pilot bin, and turning
    it by a sync offset inside the guard interval reproduces the estimate
    from those earlier FFT windows."""
    _, _, cfg, tr = small_cell(ndp_share=1.0)
    tr["channel"]["snr_db"] = 60.0
    with core.workers(2) as pool:
        inp = generate.make(tr, cfg, 11, pool)
    chan = [complex(*c) for c in tr["packets"]["ndp_channel"]]
    k = np.arange(64) - 32
    data = (np.abs(k) <= 28) & (k != 0) & ~np.isin(k, [-21, -7, 7, 21])
    n = 0
    for view, sent in zip(inp["views"], inp["sent"]):
        for s0, f in sent:
            assert f["is_ndp"]
            start, cfo = E.reference_sync(view[0].astype(np.complex128), s0)
            assert abs(start - (s0 + E.LTF_LEAD)) <= 16
            nominal = s0 + 186
            h = E.ndp_channel_at(view, nominal, 0.0, 2)
            # stream 2's cyclic shift turns its phase bin by bin
            ratio = np.abs(h[0, 0, data] / h[0, 1, data])
            assert np.allclose(ratio, abs(chan[0] / chan[1]), rtol=1e-2)
            early = E.ndp_channel_at(view, nominal - 3, 0.0, 2)
            assert np.allclose(E.shifted(early, 3)[..., data], h[..., data],
                               atol=1e-2 * np.abs(h).max())
            n += 1
    assert n >= 10


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.rx, benchmark.generate; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'gr_ieee80211_tpu', 'gr_ieee80211_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0


def test_import_guard_compares_whole_top_level_names():
    assert core.forbidden_loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert core.forbidden_loaded(["gr_ieee80211_tpu.models.rx"]) == [
        "gr_ieee80211_tpu"]
    assert core.forbidden_loaded(["gr_ieee80211_tpu_torch.models.rx",
                                  "jaxtyping", "flaxen"]) == []


@pytest.mark.parametrize("mod", ["jax", "gr_ieee80211_tpu"])
def test_run_refuses_with_a_forbidden_module_loaded(mod):
    code = ("import sys, types; sys.modules[%r] = types.ModuleType(%r); "
            "sys.path.insert(0, %r); from benchmark import run; "
            "sys.exit(run.main(['--workload', %r, '--seed', '1', "
            "'--seconds', '1']))" % (mod, mod, str(ROOT), CELL))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True)
    assert p.returncode == 3 and p.stdout == ""
    assert mod in p.stderr


def _no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_run_fails_without_a_card():
    _no_card()
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                        "--workload", CELL, "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_run_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=tmp_path, env=env)
    assert p.returncode != 0 and p.stdout == ""


def test_device_trace_arithmetic():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "w", "ts": 0,
           "dur": 100, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "span:f", "ts": 10,
           "dur": 30, "tid": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 12, "dur": 1, "tid": 1, "args": {"correlation": 7}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 50, "dur": 1, "tid": 1, "args": {"correlation": 8}},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 10,
           "args": {"correlation": 7}},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60, "dur": 20,
           "args": {"correlation": 8}}]
    d = core.DeviceTrace(ev, "w")
    assert d.window_s == pytest.approx(100e-6)
    assert d.busy_s == pytest.approx(30e-6)
    assert d.kernels == [("k2", pytest.approx(20e-6)),
                         ("k1", pytest.approx(10e-6))]
    assert d.gaps == [("outside the benchmark's spans", pytest.approx(30e-6))]
    assert d.inside("f") == pytest.approx(10e-6)
    assert d.inside("g") is None


def test_viterbi_roofline_counts_from_b_and_t():
    # (4096, 4420): 4.71e9 lane operations at 3.35e13/s = 0.1406 ms
    # (operations bound it: 9 bytes a step move in 0.0486 ms)
    assert viterbi_roofline.bound_s(4096, 4420) == pytest.approx(
        4096 * 4420 * 260 / 3.35e13)
    assert viterbi_roofline.bound_s(4096, 4420) * 1e3 == pytest.approx(
        0.1406, abs=1e-4)


def test_stretch_readers_give_nothing_without_spans():
    class T:
        device = None

        def per_item_ms(self, *a, **k):
            return k.get("default")

        def per_item_calls(self, key):
            return None

        def shapes(self, key):
            return []
    for m in BENCH["per_layer"]:
        assert reader(m["name"]).read(T()) is None


def test_judge_pairs_results_with_sent_packets():
    sent = [[(1000, {"fmt": 2, "mcs": 7, "nss": 1, "is_ndp": False,
                     "mpdus": [b"a"]})]]
    good = {"start": 1000 + E.LTF_LEAD, "ok": True, "fmt": 2, "mcs": 7,
            "nss": 1, "is_ndp": False, "mpdus": [b"a"], "psdu_len": 10,
            "cfo_hz": 0.0, "snr_db": 30.0, "rssi": 1.0, "ndp_chan": None}
    views = [np.zeros((1, 4000), np.complex64)]
    j = E.judge(views, sent, 256, 2000, [(0, [good])])
    assert j["numbers"]["packets_lost"] == 0 and j["failed"] == 0
    j = E.judge(views, sent, 256, 2000, [(0, [])])
    assert j["numbers"]["packets_lost"] == 1 and j["failed"] == 1
    j = E.judge(views, sent, 256, 2000, [(0, [dict(good, mpdus=[b"b"])])])
    assert j["numbers"]["packets_misreported"] == 1
    j = E.judge(views, sent, 256, 2000,
                [(0, [dict(good, ok=False, mpdus=[])])])
    assert j["numbers"]["data_undecoded_share"] == 1.0
