"""``tools_torch/perf_sweep.py`` against ``tools_tpu/perf_sweep.py`` on the
CPU, SISO: L MCS0 and VHT MCS0 through the waterfall (0, 3 and 6 dB, 6
packets a point).  Both tools run as subprocesses; the JAX tool's chain
calls are captured.  The timelines are byte-equal (the port's
``build_timeline`` against the JAX tool's steps written out here on the
JAX package's numpy gold modules, and against what the JAX tool decoded),
the per-slot results are equal up to the LTF near-tie allowance, and so
are the PERs."""
import json
import sys

import numpy as np
import pytest
import torch

from gr_ieee80211_tpu_torch.models import rx as PRX
from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf
from tools_torch import perf_sweep as PSW

import _perf_sweep_parity as P

torch.set_num_threads(2)

N = 6
SNRS = (0, 7, 3)
CONFIGS = [("L", 0), ("VHT", 0)]
ARGS = ["--formats", "L", "VHT", "--mcs", "0", "--n", str(N),
        "--snrs", *map(str, SNRS)]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("perf_sweep")
    jres, calls, pres, dump = P.run_both(tmp, ARGS)
    snrs = np.arange(*SNRS)
    rng_j, rng_p = np.random.default_rng(2026), np.random.default_rng(2026)
    cases = []
    for (fname, mcs), call in zip(CONFIGS, calls):
        ref, seg, spacing = P.jax_timeline(rng_j, fname, mcs, snrs, N)
        cfg, ml, w, rms = PSW.siso_wave(fname, mcs, 1, 500, rng_p)
        got, seg_p, spacing_p = PSW.build_timeline(w, rms, snrs, N, rng_p)
        cases.append(dict(name=f"{fname}_mcs{mcs}", call=call, ref=ref,
                          got=got, geo=(seg, spacing),
                          geo_p=(seg_p, spacing_p), cfg=cfg, ml=ml,
                          dump=np.load(dump / f"{fname}_mcs{mcs}.npz")))
    return jres, pres, cases


def test_jax_tool_made_one_call_per_config(sweep):
    _, _, cases = sweep
    assert len(cases) == len(CONFIGS)


@pytest.mark.parametrize("k", range(len(CONFIGS)),
                         ids=[f"{f}{m}" for f, m in CONFIGS])
def test_timelines_byte_equal(sweep, k):
    c = sweep[2][k]
    assert c["geo"] == c["geo_p"]
    assert c["got"].dtype == c["ref"].dtype == np.complex64
    assert c["got"].tobytes() == c["ref"].tobytes()
    assert P.digest(c["ref"]) == P.digest(P.timeline(c["call"]))
    assert str(c["dump"]["digest"]) == P.digest(c["ref"])


@pytest.mark.parametrize("k", range(len(CONFIGS)),
                         ids=[f"{f}{m}" for f, m in CONFIGS])
def test_per_slot_results_equal(sweep, k):
    """On the JAX tool's own timeline, the port's chain gives the JAX
    chain's per-slot results; so does the port tool's run."""
    c = sweep[2][k]
    call, (seg, spacing) = c["call"], c["geo"]
    nsnr = len(np.arange(*SNRS))
    ok_j, sync_j = P.slots(call["ok"], call["ltf_idx"], call["valid"], seg,
                           spacing, N, nsnr)
    x = from_numpy_cf(P.timeline(call), "cpu")
    ok, li, valid = PSW.decode(PRX, c["cfg"], x, 1, c["ml"],
                               PSW.max_pkts_for(nsnr * N), False)
    assert len(ok) == len(call["ok"])
    ok_p, sync_p = P.slots(ok, li, valid, seg, spacing, N, nsnr)
    P.assert_slots_agree(c["name"], ok_j, sync_j, ok_p, sync_p, N, nsnr)
    d = c["dump"]
    ok_d, sync_d = P.slots(d["ok"], d["ltf_idx"], d["valid"], seg, spacing,
                           N, nsnr)
    assert np.array_equal(ok_d, d["ok_slot"])
    P.assert_slots_agree(c["name"], ok_j, sync_j, ok_d, sync_d, N, nsnr)
    # the waterfall: nothing decodes at 0 dB, and most packets do at 6 dB
    assert not ok_j[:N].any() and ok_j[-N:].sum() >= N - 1


def test_pers_equal(sweep):
    jres, pres, _ = sweep
    P.assert_pers_agree(jres, pres, N)
    assert pres["device"] == "cpu"


def _full_size_curve(tmp_path, sweep_name, fmt):
    """The port's tool on the CPU at MCS0, n = 100, 0-30 dB in steps of 3
    (the first configuration of a sweep ``chip_smoke.py`` phase (j) runs
    on the card), and the JAX tool's curve for that sweep's command kept
    in ``tests/golden/per_sweep_jax.json``."""
    name = f"{fmt}_mcs0"
    ref = json.loads((P.ROOT / "tests" / "golden" / "per_sweep_jax.json")
                     .read_text())["sweeps"][sweep_name][name]
    out = tmp_path / "c0.json"
    P._run([sys.executable, str(P.ROOT / "tools_torch" / "perf_sweep.py"),
            "--formats", fmt, "--mcs", "0", "--n", "100", "--snrs", "0",
            "31", "3", "--device", "cpu", "--out", str(out)])
    return json.loads(out.read_text())[name], ref


def test_full_size_curve_equals_the_reference_fixture(tmp_path):
    """VHT MCS0: exactly the JAX tool's curve, bump at 9 dB included (three
    packets the reference's LTF search syncs 13-15 samples late)."""
    got, ref = _full_size_curve(tmp_path, "vht", "VHT")
    assert got["snr_db"] == ref["snr_db"] and got["per"] == ref["per"]


def test_full_size_l_curve_equals_the_reference_fixture(tmp_path):
    """L MCS0, the first configuration of the L and HT MCS0-3 sweep:
    exactly the JAX tool's curve."""
    got, ref = _full_size_curve(tmp_path, "lht", "L")
    assert got["snr_db"] == ref["snr_db"] and got["per"] == ref["per"]
