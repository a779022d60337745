"""The port's bindings of the native host runtime (``native/phyrt.cpp``):
the tests of ``tests/test_native.py`` on ``gr_ieee80211_tpu_torch.runtime
.native``, its ``fcs_ok``, ``deagg_vht`` and ``stf_detect`` equal to the
JAX package's on the same inputs, and the copy it builds into ``build/``
where the prebuilt library does not load."""
import os
import shutil

import numpy as np
import pytest

from gr_ieee80211_tpu.runtime import native as JN
from gr_ieee80211_tpu_torch.gold import bits as B, channel, mac, tx as gtx
from gr_ieee80211_tpu_torch.runtime import native as N
from gr_ieee80211_tpu_torch.spec import tables as T
from gr_ieee80211_tpu_torch.spec.params import Fmt, PhyConfig

pytestmark = pytest.mark.skipif(not N.available(), reason="no native toolchain")


def _stf_stream(seed=2, num=4):
    rng = np.random.default_rng(seed)
    wave = gtx.tx_waveform(PhyConfig(Fmt.L, 0, 1, 100), bytes(100))
    rms = np.sqrt(np.mean(np.abs(wave) ** 2))
    stream = channel.frame_stream(wave, 1.0, 0.0, num=num, gap=2000)
    return (channel.awgn(stream, rms / 10 ** (30 / 20), rng)[0]
            .astype(np.complex64), len(wave[0]))


def _ampdu(seed=1):
    rng = np.random.default_rng(seed)
    ms = [mac.qos_data_frame(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                             "02:00:00:00:00:01", "02:00:00:00:00:02",
                             "02:00:00:00:00:01", i + 1)
          for i, n in enumerate((150, 60))]
    return ms, mac.ampdu_aggregate_vht(ms) + T.bits_to_bytes(
        T.VHT_EOF_BITS) * 2


def test_crc32_fcs():
    rng = np.random.default_rng(0)
    for n in (10, 64, 333, 4000):
        frame = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        good = frame + B.fcs32(frame)
        assert N.fcs_ok(good)
        assert N.fcs_ok(good) == B.fcs_ok(good)
        bad = bytearray(good)
        bad[3] ^= 1
        assert not N.fcs_ok(bytes(bad))


def test_deagg_vht_matches_python():
    ms, psdu = _ampdu()
    assert N.deagg_vht(psdu) == mac.ampdu_deaggregate(psdu) == ms


def test_stf_detect_matches_gold():
    stream, n_wave = _stf_stream()
    idx = N.stf_detect(stream)
    assert len(idx) == 4
    # triggers land just before each STF (gap 2000 + preamble)
    expect = 2000 + np.arange(4) * (2000 + n_wave)
    assert np.all(np.abs(idx - expect) < 64)


def test_iq_ring_overlap_save():
    rb = N.IqRing(1 << 14)
    x = (np.arange(6000) + 1j * np.arange(6000)).astype(np.complex64)
    assert rb.write(x[:5000]) == 5000
    blk = rb.read_block(4096, halo=512)
    assert blk is not None and len(blk) == 4608
    assert np.array_equal(blk, x[:4608])
    # read pointer advanced by n, not n+halo: next block re-covers the halo
    assert rb.read_block(4096, halo=512) is None  # only 904 left
    rb.write(x[5000:])
    blk2 = rb.read_block(1024, halo=128)
    assert np.array_equal(blk2, x[4096: 4096 + 1152])
    rb.close()


def test_native_functions_equal_the_reference_package():
    """Same inputs, same answers as ``gr_ieee80211_tpu.runtime.native``:
    FCS verdicts on good and corrupted frames, the MPDUs of A-MPDUs with
    and without a damaged delimiter, and the STF triggers of noisy
    streams."""
    rng = np.random.default_rng(9)
    for n in (4, 31, 512, 2000):
        frame = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        for f in (frame + B.fcs32(frame), frame + bytes(4)):
            assert N.fcs_ok(f) == JN.fcs_ok(f)
    for seed in (1, 5):
        _, psdu = _ampdu(seed)
        bad = bytearray(psdu)
        bad[1] ^= 0x40
        for p in (psdu, bytes(bad), psdu[:100]):
            assert N.deagg_vht(p) == JN.deagg_vht(p)
    for seed, num in ((2, 4), (3, 7)):
        stream, _ = _stf_stream(seed, num)
        got, ref = N.stf_detect(stream), JN.stf_detect(stream)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
        assert len(got) == num


def test_builds_its_own_copy_where_the_prebuilt_library_is_missing(
        tmp_path, monkeypatch):
    """Without a loadable ``native/libphyrt.so`` the port compiles
    ``phyrt.cpp`` into its build directory and leaves the native
    directory as it was."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    src = tmp_path / "native"
    src.mkdir()
    shutil.copy(os.path.join(N._NATIVE_DIR, "phyrt.cpp"), src)
    (src / "libphyrt.so").write_bytes(b"not a shared library")
    monkeypatch.setattr(N, "_NATIVE_DIR", str(src))
    monkeypatch.setattr(N, "_BUILD_DIR", str(tmp_path / "build"))
    N._lib.cache_clear()
    try:
        assert N.available()
        assert (tmp_path / "build" / "libphyrt.so").exists()
        assert (src / "libphyrt.so").read_bytes() == b"not a shared library"
        rb = N.IqRing(1 << 10)
        assert rb.write(np.ones(100, np.complex64)) == 100
        assert rb.fill == 100
        rb.close()
    finally:
        N._lib.cache_clear()
