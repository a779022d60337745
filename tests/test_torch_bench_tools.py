"""The port's benchmark tools on the CPU at small sizes: ``bench``,
``bench_snr_sweep``, ``bench_long``, ``bench_tx`` (SU and MU),
``bench_mu`` and ``stage_times canon|fallback``.  Each writes its JSON to
``--out`` under the test's directory with the keys of its JAX
counterpart, every packet is detected and passes the FCS at 32 dB, and
nothing is written under ``results/``.  Each tool's default device is the
card: without one it raises instead of running on the CPU."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tools_torch import (bench, bench_long, bench_mu, bench_snr_sweep,
                         bench_tx, perf_sweep, stage_times, timing)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def results_untouched():
    """Nothing under results/ (the TPU's records) changes."""
    def snap():
        return {p: (p.stat().st_size, p.stat().st_mtime_ns)
                for p in (ROOT / "results").rglob("*")}
    before = snap()
    yield
    assert snap() == before


def _json_line(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return json.loads(lines[-1])


def test_bench(tmp_path, capsys):
    out = tmp_path / "bench_envelope.json"
    assert bench.main(["--device", "cpu", "--batch", "16", "--reps", "1",
                       "--out", str(out)]) == 0
    line = _json_line(capsys)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert line["device"] == "cpu" and line["value"] > 0
    env = json.loads(out.read_text())
    hi, lo = env["high_snr_32dB"], env["low_snr_floor_18dB"]
    assert (hi["n_ok"], hi["n_det"]) == (16, 16) and hi["path"] == ["fast"]
    assert lo["n_det"] == 16 and "dd" in lo["path"]
    for k in ("ms_per_batch", "pkt_per_s", "n_ok", "vs_ref_ceiling"):
        assert k in hi
    for k in ("ms_per_batch", "pkt_per_s_processed", "n_ok", "n_det",
              "vs_ref_ceiling"):
        assert k in lo
    # on the CPU the kernels' twins run: no launch is counted
    assert not any(hi["launches"].values()) and hi["k1_k2_shapes"] == []


def test_bench_stream_is_bench_py_s():
    """Both streams are ``bench.py``'s, byte for byte: its steps written
    out here on the JAX package's numpy gold modules, at its B = 4096, the
    32 dB noise summed in place into the complex64 stream, then the 18 dB
    floor's stream from the same generator."""
    from gr_ieee80211_tpu.gold import channel, mac, tx
    from gr_ieee80211_tpu.spec.params import Fmt, PhyConfig
    B = 4096
    rng = np.random.default_rng(1)
    payload = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                              "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 7)
    am = mac.ampdu_aggregate_vht([mpdu])
    cfg = PhyConfig(Fmt.VHT, 7, 1, len(am), ampdu=True)
    wave = tx.tx_waveform(cfg, am, group_id=0, partial_aid=0)[0]
    spacing = len(wave) + 240
    stream = np.zeros(B * spacing + 2048, np.complex64)
    w = channel.apply_cfo(wave, 900.0).astype(np.complex64)
    for i in range(B):
        stream[1024 + i * spacing: 1024 + i * spacing + len(wave)] = w
    rms = float(np.sqrt(np.mean(np.abs(wave) ** 2)))
    stream += (rng.normal(size=len(stream)) + 1j * rng.normal(size=len(stream))
               ).astype(np.complex64) * (rms / 10 ** (32 / 20) / np.sqrt(2))
    stream_low = np.zeros_like(stream)
    for i in range(B):
        stream_low[1024 + i * spacing: 1024 + i * spacing + len(wave)] = w
    stream_low += (rng.normal(size=len(stream))
                   + 1j * rng.normal(size=len(stream))
                   ).astype(np.complex64) * (rms / 10 ** (18 / 20)
                                             / np.sqrt(2))

    got_cfg, got_mpdu, got_am, got_wave, streams = bench.bench_streams(B)
    assert (got_mpdu, got_am) == (mpdu, am)
    assert (got_cfg.mcs, got_cfg.psdu_len, got_cfg.nsym) == (
        cfg.mcs, cfg.psdu_len, cfg.nsym)
    assert got_wave.tobytes() == wave.tobytes()
    for snr, want in ((32.0, stream), (18.0, stream_low)):
        assert streams[snr].dtype == np.complex64
        assert streams[snr].tobytes() == want.tobytes(), snr


def test_bench_snr_sweep(tmp_path):
    out = tmp_path / "tvs.json"
    assert bench_snr_sweep.main(["--device", "cpu", "--batch", "8",
                                 "--snrs", "20", "33", "12", "--reps", "1",
                                 "--out", str(out)]) == 0
    blob = json.loads(out.read_text())
    assert blob["device"] == "cpu"
    pts = blob["points"]
    assert [p["snr_db"] for p in pts] == [20, 32]
    for p in pts:
        for k in ("ms_per_batch", "pkt_per_s", "n_ok", "n_det", "path",
                  "launches"):
            assert k in p
        assert p["n_det"] == 8
    assert pts[1]["n_ok"] == 8 and pts[1]["path"] == ["fast"]


def test_bench_long(tmp_path, capsys):
    out = tmp_path / "long.json"
    assert bench_long.main(["4", "2", "--device", "cpu", "--reps", "1",
                            "--out", str(out)]) == 0
    blob = json.loads(out.read_text())
    assert blob == _json_line(capsys)
    assert 32000 < blob["n_trellis"] < 32700
    assert (blob["n_ok"], blob["n_det"]) == (4, 4)
    assert blob["path"] == ["fast", "fast"]          # two chunks of two
    for k in ("ms_per_batch", "pkt_per_s", "msamp_per_s", "vs_ref_ceiling"):
        assert blob[k] > 0


@pytest.mark.parametrize("mu", [False, True], ids=["su", "mu"])
def test_bench_tx(tmp_path, capsys, mu):
    out = tmp_path / "tx.json"
    argv = ["8", "--device", "cpu", "--reps", "2", "--out", str(out)]
    assert bench_tx.main(argv + (["--mu"] if mu else [])) == 0
    line = _json_line(capsys)
    blob = json.loads(out.read_text())
    assert blob[line["metric"]] == line
    for k in ("metric", "value", "unit", "samples_per_s", "device"):
        assert k in line
    assert line["max_abs_err_vs_gold"] < (2e-5 if mu else 2e-6)
    assert line["batch"] == 8


def test_bench_mu(tmp_path, capsys):
    out = tmp_path / "mu.json"
    assert bench_mu.main(["16", "--device", "cpu", "--reps", "1",
                          "--out", str(out)]) == 0
    blob = json.loads(out.read_text())
    assert blob == _json_line(capsys)
    assert blob["su_2x2_ok"] == blob["mu_sta_ok"] == 16
    assert blob["su2"]["n_det"] == blob["mu0"]["n_det"] == 16
    assert blob["su_2x2_vht_mcs7_500B_pkts_per_s"] > 0
    assert blob["mu_sta_vht_mcs3_pkts_per_s"] > 0 and blob["batch"] == 16


def test_stage_times_canon(tmp_path, capsys):
    out = tmp_path / "canon.json"
    assert stage_times.main(["canon", "1", "--batch", "12", "--device", "cpu",
                             "--out", str(out)]) == 0
    (row,) = json.loads(out.read_text())["paths"]
    assert row["canon_nsym"] == 13 and row["real_nsym"] == [11, 11, 12]
    assert row["with_n_real"]["tiers"] == ["fast"]
    assert row["without_n_real"]["tiers"] != ["fast"]
    assert row["with_n_real"]["psdus_exact"] == 12
    assert row["without_n_real"]["psdus_exact"] == 12
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["device"] == "cpu"


def test_stage_times_fallback(tmp_path):
    out = tmp_path / "fb.json"
    assert stage_times.main(["fallback", "1", "--batch", "16", "--device",
                             "cpu", "--out", str(out)]) == 0
    (row,) = json.loads(out.read_text())["paths"]
    for k in ("syn", "fast", "tile8", "tile300", "full", "gather", "seg16",
              "scatter"):
        assert row[k]["ms"] > 0, k
    for k in ("fast", "tile8", "tile300", "full", "seg16"):
        assert row[k]["rows_equal"] == row[k]["rows"], k
    assert row["tile8"]["tiers"] and row["tile300"]["tiers"]


def test_stage_timer_synchronizes_the_device_it_times():
    """On the CPU the timer runs without touching CUDA, nests stages and
    restores what it wrapped."""
    import types
    mod = types.SimpleNamespace()
    mod.inner = lambda x: x + 1
    mod.outer = lambda x: mod.inner(x) * 2
    timer = stage_times.StageTimer(torch.device("cpu"))
    timer.wrap(mod, "inner")
    timer.wrap(mod, "outer")
    assert mod.outer(1) == 4
    timer.unwrap()
    rep = timer.report(1)
    assert set(rep) == {"outer", "outer > inner"}
    assert rep["outer > inner"]["calls"] == 1
    assert mod.outer(1) == 4 and len(timer.calls) == 2


@pytest.mark.parametrize("tool,argv", [
    (bench, []), (bench_snr_sweep, []), (bench_long, []), (bench_tx, []),
    (bench_mu, []), (perf_sweep, []), (stage_times, ["canon"]),
    (stage_times, ["fallback"])],
    ids=["bench", "bench_snr_sweep", "bench_long", "bench_tx", "bench_mu",
         "perf_sweep", "stage_times_canon", "stage_times_fallback"])
def test_default_device_is_the_card(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tool.main(argv)


def test_out_default_is_results_torch():
    assert timing.out_path("x.json") == ROOT / "results_torch" / "x.json"
    assert timing.out_path("x.json", "/tmp/y.json") == Path("/tmp/y.json")
    assert timing.device_info(torch.device("cpu")) == "cpu"
