"""The port's runtime harness tools on the CPU at small sizes:
``bench_daemon`` (the resident engine and one low rung of the rate
ladder), ``latency_report`` (one MCS, two packets a payload, every packet
back through the daemon loop) and ``multihost_scaling`` with 1 and 2 Gloo
ranks (every configuration decodes every packet).  Every socket binds
port 0; outputs land in ``--out`` under the test's directory."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tools_torch import bench_daemon, latency_report, multihost_scaling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def test_bench_daemon_low_rung(tmp_path, capsys):
    out = tmp_path / "daemon.json"
    assert bench_daemon.main([
        "--device", "cpu", "--rates", "0.05", "--seconds", "1",
        "--block", "32768", "--halo", "8192", "--pkts", "8",
        "--resident-blocks", "1", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    blob = json.loads(out.read_text())
    assert blob["device"] == "cpu"
    res = blob["resident_block_processing"]
    assert res["pkts_per_block"] == res["ok_per_block"] > 0
    (rung,) = blob["runs"]
    assert rung["lossless"] and rung["samples_dropped"] == 0
    # 50k samples a second for 1 s: two whole captures of 8 packets
    assert rung["pkts_ok"] == rung["pkts_expected"] == 16
    assert blob["max_lossless"] == rung and line["max_lossless_msps"] == 0.05
    # the launch counters over every run; on the CPU the twins run
    assert not any(blob["launches"].values()) and blob["k1_k2_shapes"] == []


def test_latency_report_one_mcs(tmp_path, capsys):
    out = tmp_path / "lat" / "latency.json"
    assert latency_report.main(["7", "2", "1,4", "--device", "cpu",
                                "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["lost"] == 0
    blob = json.loads(out.read_text())
    assert set(blob["daemon_rtt"]) == {"mcs7_30B", "mcs7_300B"}
    for v in blob["daemon_rtt"].values():
        assert v["n"] == 2 and v["lost"] == 0 and v["p95_ms"] >= v["p50_ms"]
    assert set(blob["fused_chain"]) == {f"mcs7_{p}B_B{b}" for p in (30, 300)
                                        for b in (1, 4)}
    for v in blob["fused_chain"].values():
        assert v["ok"] == v["of"] and v["p50_ms"] > 0
    assert not any(blob["launches"].values()) and blob["k1_k2_shapes"] == []
    md = (out.parent / "LATENCY.md").read_text()
    assert "Device: cpu" in md and "| 7 |" in md


def test_multihost_scaling_two_ranks(tmp_path):
    """1 and 2 ranks over Gloo in subprocesses: dp and sp decode every
    packet (the tool raises otherwise)."""
    out = tmp_path / "mh.json"
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools_torch" / "multihost_scaling.py"),
         "--ranks", "1,2", "--device", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    blob = json.loads(out.read_text())
    assert blob["device"] == "cpu"
    assert [p["n_proc"] for p in blob["curve"]["dp"]] == [1, 2]
    assert [len(p["ms_per_chain_all"]) for p in blob["curve"]["sp"]] == [1, 2]
    assert "not scaling" in blob["caveat"]


@pytest.mark.parametrize("tool,argv", [
    (bench_daemon, []), (latency_report, []), (multihost_scaling, [])],
    ids=["bench_daemon", "latency_report", "multihost_scaling"])
def test_default_device_is_the_card(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tool.main(argv)
