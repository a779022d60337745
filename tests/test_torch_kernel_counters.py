"""Kernel launches as counters of the program's registry (``utils/trace``).

``ops/cuda_lib.launch`` counts every accepted launch as
``kernel.<wrapper>.launches`` and ``kernel.<wrapper>.at.<shape>``; on the
CPU, where a stub stands in for the library and the stream, that is held
for every entry point, and a refused launch raises and counts nothing.
Every kernel wrapper given CPU tensors runs its twin and moves no
``kernel.*`` counter.  The harness tools' helpers turn the change of the
counters into the launches, K1/K2's shapes and the decode path."""
import types

import numpy as np
import pytest
import torch

from gr_ieee80211_tpu_torch.ops import cuda_lib as CL
from gr_ieee80211_tpu_torch.ops import frontend as FE
from gr_ieee80211_tpu_torch.ops import ofdm as OF
from gr_ieee80211_tpu_torch.ops import viterbi as V
from gr_ieee80211_tpu_torch.ops import viterbi_kernels as VK
from gr_ieee80211_tpu_torch.ops.cplx import CF
from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig
from gr_ieee80211_tpu_torch.utils import trace
from tools_torch import timing

torch.set_num_threads(2)

WRAPPERS = ("acs_sweep", "traceback_sweep", "acs_sweep_packed",
            "traceback_sweep_packed", "derotate", "scan_viterbi",
            "payload_chanest", "payload_demod")


def _moved(before: dict) -> dict:
    return timing.moved(before, trace.snapshot())


@pytest.fixture
def stub_lib(monkeypatch):
    """``cuda_lib.launch`` against a stub library on a stub stream: each
    entry point returns ``rc[0]`` and records its arguments."""
    rc, calls = [0], []

    class _Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return rc[0]
            return entry

    class _Device:
        def __init__(self, device):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(CL, "lib", lambda: _Lib())
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    return rc, calls


def test_every_entry_point_names_its_wrapper():
    assert [CL.wrapper_name(ep) for ep in CL._ENTRY_POINTS] == list(WRAPPERS)


@pytest.mark.parametrize("entry", list(CL._ENTRY_POINTS))
def test_launch_adds_the_wrapper_and_shape_counters(stub_lib, entry):
    rc, calls = stub_lib
    before = trace.snapshot()
    CL.launch(entry, "cpu", 1, 2, shape=(64, 4480))
    CL.launch(entry, "cpu", 3, shape=(64, 4480))
    CL.launch(entry, "cpu", shape=(8, 2, 1, 3))
    name = CL.wrapper_name(entry)
    assert _moved(before) == {f"kernel.{name}.launches": 3,
                              f"kernel.{name}.at.64x4480": 2,
                              f"kernel.{name}.at.8x2x1x3": 1}
    # the arguments, then the stream
    assert calls == [(entry, (1, 2, 7)), (entry, (3, 7)), (entry, (7,))]


def test_refused_launch_raises_and_counts_nothing(stub_lib):
    rc, calls = stub_lib
    rc[0] = 700
    before = trace.snapshot()
    with pytest.raises(RuntimeError, match="cudaError 700"):
        CL.launch("gr80211_acs_sweep", "cpu", 1, shape=(4, 64))
    assert len(calls) == 1 and _moved(before) == {}


def _cpu_call(name: str):
    """A small call of wrapper ``name`` on CPU tensors."""
    rng = np.random.default_rng(5)
    llr = torch.from_numpy(rng.normal(size=(3, 64, 2)).astype(np.float32))
    planes = llr[:, :, 0].T.contiguous(), llr[:, :, 1].T.contiguous()
    if name == "acs_sweep":
        return VK.acs_sweep(llr)
    if name == "traceback_sweep":
        return VK.traceback_sweep(VK.acs_sweep(llr)[0])
    if name == "acs_sweep_packed":
        return VK.acs_sweep_packed(*planes)
    if name == "traceback_sweep_packed":
        return VK.traceback_sweep_packed(*VK.acs_sweep_packed(*planes)[:2])
    if name == "derotate":
        x = torch.from_numpy(rng.normal(size=(2, 2, 160)).astype(np.float32))
        return FE.derotate(CF(x[0], x[1]), torch.tensor([100.0, -50.0]), 160)
    if name == "scan_viterbi":
        return V.scan_viterbi(llr[:, :26].contiguous())
    x = torch.from_numpy(rng.normal(size=(2, 2, 1, 400)).astype(np.float32))
    if name == "payload_chanest":
        return OF.payload_chanest(CF(x[0], x[1]), Fmt.L, 0, 1)
    h = torch.from_numpy(rng.normal(size=(2, 2, 1, 1, 64)).astype(np.float32))
    return OF.payload_demod(CF(x[0], x[1]), 208, CF(h[0], h[1]),
                            CF(h[0][:, :, 0, :4], h[1][:, :, 0, :4]),
                            PhyConfig(Fmt.L, 0, 1, 1))


@pytest.mark.parametrize("name", WRAPPERS)
def test_cpu_tensors_take_the_twin_and_count_no_launch(name):
    before = trace.snapshot()
    _cpu_call(name)
    assert not {k for k in _moved(before) if k.startswith("kernel.")}


def test_tools_read_launches_and_shapes_from_the_change():
    diff = {"kernel.acs_sweep.launches": 2, "kernel.acs_sweep.at.64x4480": 1,
            "kernel.acs_sweep.at.8x128": 1,
            "kernel.traceback_sweep.launches": 1,
            "kernel.traceback_sweep.at.64x4480": 1,
            "kernel.scan_viterbi.launches": 4,
            "kernel.scan_viterbi.at.8x26": 4, "sync.total": 9}
    assert timing.kernel_launches(diff) == {
        "launches": {"acs_sweep": 2, "traceback_sweep": 1,
                     "acs_sweep_packed": 0, "traceback_sweep_packed": 0,
                     "derotate": 0, "scan_viterbi": 4, "payload_chanest": 0,
                     "payload_demod": 0},
        "k1_k2_shapes": [[8, 128], [64, 4480]]}
    assert timing.moved({"a": 1, "b": 2}, {"a": 1, "b": 5, "c": 1}) == {
        "b": 3, "c": 1}


def test_tools_read_the_decode_path_from_the_change():
    diff = {"decode.tier.fast": 2, "decode.tier.win128": 1,
            "rx.payload.dd": 1, "decode.rows": 40, "rx.bucket.calls": 3}
    assert timing.decode_path(diff) == ["fast", "fast", "win128", "dd"]
    assert timing.decode_path({}) == []
