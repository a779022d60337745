"""Shared steps of the PER-sweep parity tests (``test_torch_perf_sweep*``):
run ``tools_tpu/perf_sweep.py`` and ``tools_torch/perf_sweep.py`` as
subprocesses on the CPU with the same arguments, capture what the JAX
tool decoded, and compare slot by slot."""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from gr_ieee80211_tpu.gold import channel as JCH, mac as JMAC, tx as JTX
from gr_ieee80211_tpu.spec.params import Fmt as JFmt, PhyConfig as JCfg

ROOT = Path(__file__).resolve().parents[1]

# runs the JAX tool unchanged, with its chain wrapped so that each call's
# timeline and per-row results land in an .npz
_CAPTURE = """
import runpy, sys
import numpy as np
sys.path.insert(0, {root!r})
import jax
jax.config.update("jax_platforms", "cpu")
from gr_ieee80211_tpu.models import rx as R
calls = []
def wrap(fn):
    def inner(cfg, stream, *a, **k):
        out = fn(cfg, stream, *a, **k)
        calls.append([np.asarray(stream.re), np.asarray(stream.im)]
                     + [np.asarray(x) for x in out])
        return out
    return inner
R.rx_chain_ok = wrap(R.rx_chain_ok)
R.rx_chain_ok_mu = wrap(R.rx_chain_ok_mu)
sys.argv = ["perf_sweep.py"] + {args!r}
runpy.run_path({tool!r}, run_name="__main__")
np.savez({dump!r}, **{{f"{{k}}{{i}}": v for i, c in enumerate(calls)
                      for k, v in zip(("re", "im", "ok", "ltf_idx", "valid"),
                                      c)}})
"""


def _run(cmd):
    # two threads a subprocess: the test workers already fill the cores,
    # and oversubscribed torch threads slow a sweep tenfold
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def run_both(tmp: Path, args: list[str]):
    """Both tools on ``args``; returns (JAX json, JAX captured calls,
    port json, port dump directory)."""
    jdump = tmp / "jax_calls.npz"
    code = _CAPTURE.format(root=str(ROOT), args=[*args, "--cpu", "--out",
                                                 str(tmp / "jax.json")],
                           tool=str(ROOT / "tools_tpu" / "perf_sweep.py"),
                           dump=str(jdump))
    _run([sys.executable, "-c", code])
    _run([sys.executable, str(ROOT / "tools_torch" / "perf_sweep.py"),
          *args, "--device", "cpu", "--out", str(tmp / "port.json"),
          "--dump", str(tmp / "port")])
    data = np.load(jdump)
    calls = [{k: data[f"{k}{i}"] for k in ("re", "im", "ok", "ltf_idx",
                                            "valid")}
             for i in range(len(data.files) // 5)]
    return (json.loads((tmp / "jax.json").read_text()), calls,
            json.loads((tmp / "port.json").read_text()), tmp / "port")


def timeline(call) -> np.ndarray:
    """The complex64 timeline a captured JAX call decoded."""
    return (call["re"] + 1j * call["im"]).astype(np.complex64)


def digest(stream: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(stream, np.complex64)
                          .tobytes()).hexdigest()


def slots(ok, ltf_idx, valid, seg, spacing, n, nsnr):
    """``tools_tpu/perf_sweep.py:180-194`` written out: per slot, ok and
    the sync position of the detection mapped to it (-1: none)."""
    ok_slot = np.zeros(nsnr * n, bool)
    sync = np.full(nsnr * n, -1, np.int64)
    for j in range(len(ok)):
        if not valid[j]:
            continue
        s, rem = divmod(int(ltf_idx[j]), seg)
        i = (rem - 512) // spacing
        if 0 <= i < n and abs(rem - 512 - i * spacing - 186) < 300:
            sync[s * n + i] = int(ltf_idx[j])
            if ok[j]:
                ok_slot[s * n + i] = True
    return ok_slot, sync


def assert_slots_agree(name, ok_j, sync_j, ok_p, sync_p, n, nsnr):
    """Per-slot ok flags equal, except where the two sync positions
    differ (the LTF near-tie), at most one slot per SNR point; each such
    slot is printed."""
    for s in range(nsnr):
        sl = slice(s * n, (s + 1) * n)
        diff = np.flatnonzero(ok_j[sl] != ok_p[sl])
        for i in diff:
            print(f"{name}: SNR point {s} slot {i}: JAX ok={ok_j[sl][i]} "
                  f"sync {sync_j[sl][i]}, port ok={ok_p[sl][i]} sync "
                  f"{sync_p[sl][i]}")
            assert sync_j[sl][i] != sync_p[sl][i], (name, s, i)
        assert len(diff) <= 1, (name, s, diff)


def assert_pers_agree(jres, pres, n):
    """The same configurations and SNR points; each PER within the one
    near-tie slot a point may differ by."""
    names = sorted(k for k in jres)
    assert names == sorted(k for k in pres if k != "device")
    for k in names:
        assert pres[k]["snr_db"] == jres[k]["snr_db"], k
        for key in ("payload", "n", "users"):
            assert pres[k].get(key) == jres[k].get(key), (k, key)
        assert np.abs(np.subtract(pres[k]["per"], jres[k]["per"])).max() \
            <= 1.0 / n + 1e-12, (k, jres[k]["per"], pres[k]["per"])


ADDR = ("f4:69:d5:80:0f:a0", "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0")


def jax_timeline(rng, fname, mcs, snrs, n, nss=1):
    """``tools_tpu/perf_sweep.py:154-178`` on the JAX package's gold
    modules: (stream, seg, spacing)."""
    fmt = JFmt[fname]
    payload = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    mpdu = JMAC.qos_data_frame(payload, *ADDR, 7)
    if fmt == JFmt.VHT:
        psdu = JMAC.ampdu_aggregate_vht([mpdu])
        cfg = JCfg(fmt, mcs, nss, len(psdu), ampdu=True)
    else:
        psdu = mpdu
        cfg = JCfg(fmt, mcs, nss, len(psdu))
    kw = dict(group_id=0, partial_aid=0) if fmt == JFmt.VHT else {}
    wave = JTX.tx_waveform(cfg, psdu, **kw)
    if nss == 2:
        h2 = np.eye(2) + 0.25 * (rng.normal(size=(2, 2))
                                 + 1j * rng.normal(size=(2, 2)))
        wave = h2 @ wave
    rms = float(np.sqrt(np.mean(np.abs(wave[0]) ** 2)))
    nsnr = len(snrs)
    spacing = wave.shape[1] + 400
    seg = n * spacing + 1024
    stream = np.empty((nss, nsnr * seg), np.complex64)
    w = np.stack([JCH.apply_cfo(wv, 800.0) for wv in wave]
                 ).astype(np.complex64)
    for s, snr in enumerate(snrs):
        namp = rms / 10 ** (snr / 20)
        block = (rng.normal(size=(nss, seg)) + 1j * rng.normal(size=(nss, seg))
                 ).astype(np.complex64) * (namp / np.sqrt(2))
        for i in range(n):
            o = 512 + i * spacing
            block[:, o: o + w.shape[1]] += w
        stream[:, s * seg: (s + 1) * seg] = block
    return stream, seg, spacing
