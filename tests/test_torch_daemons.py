"""The port's daemons and examples (``tools_torch/``) on the CPU:
``rx_daemon --file --once`` decodes a replayed capture and reports every
MPDU on the MAC wire, ``tx_daemon --out`` turns two MAC requests into a
sample file the gold receiver decodes, ``cmu_demo`` closes the MU loop,
and the sample-file generators write the same bytes as their
``tools_tpu/`` originals from the same arguments.  Every socket binds
port 0."""
import importlib.util
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from gr_ieee80211_tpu_torch.gold import channel, mac, rx as grx, tx as gtx
from gr_ieee80211_tpu_torch.runtime import native as NAT
from gr_ieee80211_tpu_torch.runtime.udp_phy import parse_phy_to_mac
from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
from gr_ieee80211_tpu_torch.utils.io import read_cf32, write_cf32

ROOT = Path(__file__).resolve().parents[1]
ENV = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
       "OMP_NUM_THREADS": "2"}


def _tool(pkg: str, name: str):
    """Import ``<pkg>/<name>.py`` by path (``tools_tpu`` is no package)."""
    spec = importlib.util.spec_from_file_location(f"_{pkg}_{name}",
                                                  ROOT / pkg / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(rng):
    """Four packets (L, HT, VHT A-MPDU, L) at 30 dB, a few blocks of
    8192 samples long; (stream, MPDUs in order, (fmt, mcs) of each)."""
    s = np.zeros(4 * 8192, np.complex64)
    pos, mpdus, kinds = 500, [], []
    for k, (fmt, mcs) in enumerate(((Fmt.L, 2), (Fmt.HT, 4), (Fmt.VHT, 5),
                                    (Fmt.L, 6))):
        mpdu = mac.qos_data_frame(bytes(rng.integers(0, 256, 90,
                                                     dtype=np.uint8)),
                                  "02:00:00:00:00:01", "02:00:00:00:00:02",
                                  "02:00:00:00:00:01", k)
        if fmt == Fmt.VHT:
            psdu = mac.ampdu_aggregate_vht([mpdu])
            w = gtx.tx_waveform(PhyConfig(fmt, mcs, 1, len(psdu), ampdu=True),
                                psdu, group_id=0, partial_aid=0)[0]
        else:
            w = gtx.tx_waveform(PhyConfig(fmt, mcs, 1, len(mpdu)), mpdu)[0]
        s[pos: pos + len(w)] = w
        pos += len(w) + 5000
        mpdus.append(mpdu)
        kinds.append((int(fmt), mcs))
    assert pos < len(s)
    rms = np.sqrt(np.mean(np.abs(w) ** 2))
    return channel.awgn(s[None], rms / 10 ** (30 / 20), rng)[0], mpdus, kinds


@pytest.mark.skipif(not NAT.available(), reason="native runtime unavailable")
def test_rx_daemon_replays_a_file_once(tmp_path):
    stream, mpdus, kinds = _capture(np.random.default_rng(31))
    path = tmp_path / "cap.bin"
    write_cf32(str(path), stream)
    lsock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
    try:
        out = subprocess.run(
            [sys.executable, "tools_torch/rx_daemon.py", "--file", str(path),
             "--once", "--device", "cpu", "--block", "8192", "--halo",
             "4096", "--report-port", str(lsock.getsockname()[1])],
            cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "done: " in out.stderr and \
            f"{len(mpdus)}/{len(mpdus)} packets ok" in out.stderr, out.stderr
        lsock.settimeout(2.0)
        got = []
        for _ in mpdus:
            fmt, pl, mcs = parse_phy_to_mac(lsock.recvfrom(65536)[0])
            got.append((fmt, mcs, pl))
    finally:
        lsock.close()
    assert sorted(got) == sorted((f, m, p) for (f, m), p in zip(kinds,
                                                                 mpdus))


def test_tx_daemon_writes_a_decodable_stream(tmp_path):
    out_path = tmp_path / "tx.bin"
    proc = subprocess.Popen(
        [sys.executable, "tools_torch/tx_daemon.py", "--out", str(out_path),
         "--port", "0", "--device", "cpu"],
        cwd=ROOT, env=ENV, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        assert "MAC->PHY requests on udp:" in line, line
        port = int(line.split("udp:")[1].split(";")[0])
        sent, n_samples = [], 0
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for fmt, mcs, seq in ((0, 3, 1), (2, 5, 2)):
            mpdu = mac.qos_data_frame(b"tx daemon " * 8, "02:00:00:00:00:01",
                                      "02:00:00:00:00:02",
                                      "02:00:00:00:00:01", seq)
            psdu = mac.ampdu_aggregate_vht([mpdu]) if fmt == 2 else mpdu
            sock.sendto(bytes([fmt, mcs, 1, len(psdu) & 0xFF,
                               len(psdu) >> 8]) + psdu, ("127.0.0.1", port))
            sent.append(mpdu)
            cfg = PhyConfig(Fmt(fmt), mcs, 1, len(psdu), ampdu=fmt == 2)
            n_samples += gtx.tx_waveform(cfg, psdu).shape[-1] + 1200  # gap
        sock.close()
        deadline = time.time() + 120
        while (not out_path.exists() or out_path.stat().st_size
               < 8 * n_samples) and time.time() < deadline:
            time.sleep(0.1)
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=30)
    x = read_cf32(str(out_path))
    assert len(x) == n_samples
    pkts = grx.receive(x[None])
    assert [p.mpdus[0] for p in pkts if p.ok] == sent


def test_cmu_demo_closes_the_loop(capsys):
    assert _tool("tools_torch", "cmu_demo").main(["--device", "cpu"]) == 0
    assert "closed loop: SUCCESS" in capsys.readouterr().out


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_sample_generators_write_the_reference_bytes(tmp_path,
                                                     monkeypatch):
    """``pkt_gen_example``, ``pkt_gen_ow_example`` and ``cmu_offline
    --demo`` of the port write the files the ``tools_tpu/`` originals
    write, byte for byte, from the same arguments."""
    monkeypatch.chdir(tmp_path)
    for pkg in ("tools_tpu", "tools_torch"):
        d = tmp_path / pkg
        d.mkdir()
        _tool(pkg, "pkt_gen_example").main(str(d / "gen"))
        _tool(pkg, "pkt_gen_ow_example").main(str(d / "ow"))
        monkeypatch.setattr(sys, "argv", [
            "cmu_offline.py", "--demo", "--chan0", str(d / "c0.bin"),
            "--chan1", str(d / "c1.bin"), "--out", str(d / "mu")])
        _tool(pkg, "cmu_offline").main()
    ref, got = _files(tmp_path / "tools_tpu"), _files(tmp_path / "tools_torch")
    assert len(got) == 8 and got.keys() == ref.keys()
    for name in got:
        assert got[name] == ref[name], name
