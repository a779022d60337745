"""The port's transmit engine (``models.tx``, on the CPU) vs the JAX
package's on the same seeded payloads.

Bits are exact: the scrambled and the BCC-coded bits of every stage that
both packages expose, for all 127 seeds, equal each other and the port's
numpy gold model.  Waveforms are float32 sums of 64 IDFT terms taken in
another order (the port applies the float32 IDFT matrices in float64), so
they are held to the tolerances of the reference's own tests against its
gold model (``tests/test_engines.py``): max abs error < 2e-6 for a
single-user waveform, < 2e-5 for an MU waveform with a spatial mapping Q.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gr_ieee80211_tpu.gold import mac
from gr_ieee80211_tpu.models import tx as JTX
from gr_ieee80211_tpu.ops.cplx import from_host
from gr_ieee80211_tpu.spec.params import Fmt, MuConfig, PhyConfig
from gr_ieee80211_tpu_torch.gold import bits as PGB
from gr_ieee80211_tpu_torch.gold import sounding as PSND
from gr_ieee80211_tpu_torch.gold import tx as PGTX
from gr_ieee80211_tpu_torch.models import tx as PTX
from gr_ieee80211_tpu_torch.ops.cplx import from_numpy_cf, to_numpy
from gr_ieee80211_tpu_torch.spec.params import from_reference

torch.set_num_threads(2)

TOL_SU = 2e-6
TOL_MU = 2e-5

#: the configs of tests/test_engines.py
CONFIGS = [(Fmt.L, 0, 1), (Fmt.L, 7, 1), (Fmt.HT, 4, 1), (Fmt.HT, 12, 2),
           (Fmt.VHT, 8, 1), (Fmt.VHT, 5, 2)]
SEEDS = [11, 93, 127, 1]


def _mk(rng, fmt, mcs, nss, n=120):
    mpdu = mac.qos_data_frame(bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                              "02:00:00:00:00:01", "02:00:00:00:00:02",
                              "02:00:00:00:00:01", 1)
    if fmt == Fmt.VHT:
        payload = mac.ampdu_aggregate_vht([mpdu])
        return payload, PhyConfig(fmt, mcs, nss, len(payload), ampdu=True)
    return mpdu, PhyConfig(fmt, mcs, nss, len(mpdu))


def _jax_wave(cf):
    return np.asarray(cf.re) + 1j * np.asarray(cf.im)


def _vht_kw(cfg):
    return dict(group_id=0, partial_aid=0) if cfg.fmt == Fmt.VHT else {}


@pytest.mark.parametrize("fmt,mcs,nss", CONFIGS)
def test_tx_batch_matches(fmt, mcs, nss):
    """Four different payloads with four seeds through both ``tx_batch``:
    the scrambled and coded bits equal (each other and the gold model's),
    the waveforms within 2e-6 of the reference's and of the gold model's."""
    rng = np.random.default_rng(17 + mcs)
    first, cfg = _mk(rng, fmt, mcs, nss)
    pays = [first] + [_mk(rng, fmt, mcs, nss)[0] for _ in SEEDS[1:]]
    pcfg = from_reference(cfg)
    arr = np.stack([np.frombuffer(p, np.uint8) for p in pays])
    seeds = np.asarray(SEEDS, np.int32)

    # bit stages: SERVICE + payload + pad -> scrambled -> coded
    st = PTX._static_parts(pcfg, 0, 0)
    stj = JTX._static_parts(cfg, 0, 0)
    for k in ("service", "tail", "tx_perm", "punct_idx"):
        assert np.array_equal(st[k], stj[k]), k
    bits = np.concatenate([np.tile(st["service"], (4, 1)),
                           np.unpackbits(arr, axis=1, bitorder="little"),
                           np.tile(st["tail"], (4, 1))], axis=1)
    scr_j = np.asarray(JTX._scramble_batch(jnp.asarray(bits),
                                           jnp.asarray(seeds)))
    scr_p = PTX._scramble_batch(torch.from_numpy(bits),
                                torch.from_numpy(seeds))
    assert scr_p.dtype == torch.uint8
    assert np.array_equal(scr_j, scr_p.numpy())
    cod_j = np.asarray(JTX._bcc_encode_batch(jnp.asarray(scr_j)))
    cod_p = PTX._bcc_encode_batch(scr_p)
    assert np.array_equal(cod_j, cod_p.numpy())
    for i, seed in enumerate(SEEDS):
        assert np.array_equal(scr_p[i].numpy(), PGB.scramble(bits[i], seed))
        assert np.array_equal(cod_p[i].numpy(),
                              PGB.bcc_encode(scr_p[i].numpy()))
    assert np.array_equal(
        PTX._bytes_to_bits(torch.from_numpy(arr)).numpy(),
        np.unpackbits(arr, axis=1, bitorder="little"))

    ref = _jax_wave(JTX.tx_batch(cfg, jnp.asarray(arr), jnp.asarray(seeds),
                                 0, 0))
    got = to_numpy(PTX.tx_batch(pcfg, torch.from_numpy(arr),
                                torch.from_numpy(seeds), 0, 0))
    assert got.shape == ref.shape == (4, nss, cfg.n_samples)
    assert np.abs(got - ref).max() < TOL_SU
    for i, seed in enumerate(SEEDS):
        gold = PGTX.tx_waveform(pcfg, pays[i], seed=seed,
                                **_vht_kw(cfg))
        assert np.abs(got[i] - gold).max() < TOL_SU, i


@pytest.mark.parametrize("fmt,mcs,nss", CONFIGS)
def test_tx_engine_matches(fmt, mcs, nss):
    """``TxEngine.tx`` (default seed 93) vs the JAX engine and the port's
    gold model, as ``test_tx_engine_matches_gold`` has it."""
    rng = np.random.default_rng(17)
    payload, cfg = _mk(rng, fmt, mcs, nss)
    ref = JTX.TxEngine().tx(cfg, [payload] * 3)
    got = PTX.TxEngine(device="cpu").tx(from_reference(cfg), [payload] * 3)
    gold = PGTX.tx_waveform(from_reference(cfg), payload, **_vht_kw(cfg))
    assert got.shape == ref.shape == (3,) + gold.shape
    assert got.dtype == ref.dtype == np.complex64
    assert np.abs(got - ref).max() < TOL_SU
    assert np.abs(got - gold[None]).max() < TOL_SU


def test_scramble_all_seeds():
    """Every seed 1..127 on one random bit row: the direct gather of the
    127-periodic sequence equals the reference's one-hot product and the
    bit-serial scrambler."""
    rng = np.random.default_rng(3)
    bits = np.tile(rng.integers(0, 2, (1, 700)).astype(np.uint8), (127, 1))
    seeds = np.arange(1, 128, dtype=np.int32)
    ref = np.asarray(JTX._scramble_batch(jnp.asarray(bits),
                                         jnp.asarray(seeds)))
    got = PTX._scramble_batch(torch.from_numpy(bits),
                              torch.from_numpy(seeds)).numpy()
    assert np.array_equal(ref, got)
    for i, seed in enumerate(seeds):
        assert np.array_equal(got[i], PGB.scramble(bits[i], int(seed))), seed
    # 127 distinct starts of the sequence
    assert len({(got[i] ^ bits[i])[:7].tobytes() for i in range(127)}) == 127


def test_bcc_encode_all_seeds():
    """The rate-1/2 encoder on 127 scrambled rows (one a seed), odd and
    even lengths: equal to the reference and to the gold encoder."""
    rng = np.random.default_rng(4)
    for n in (1, 6, 7, 433):
        bits = rng.integers(0, 2, (127, n)).astype(np.uint8)
        seeds = np.arange(1, 128, dtype=np.int32)
        scr = PTX._scramble_batch(torch.from_numpy(bits),
                                  torch.from_numpy(seeds))
        ref = np.asarray(JTX._bcc_encode_batch(jnp.asarray(scr.numpy())))
        got = PTX._bcc_encode_batch(scr)
        assert got.dtype == torch.uint8 and got.shape == (127, 2 * n)
        assert np.array_equal(ref, got.numpy())
        for i in (0, 63, 126):
            assert np.array_equal(got[i].numpy(),
                                  PGB.bcc_encode(scr[i].numpy()))


def test_tx_engine_golden_su(golden):
    """Every single-user golden fixture through the port's ``TxEngine``,
    and through the port's gold model at the fixtures' own tolerance."""
    names = [str(n) for n in golden["names"]]
    assert len(names) >= 6
    eng = PTX.TxEngine(device="cpu")
    for name in names:
        ref = golden[f"{name}_sig"]
        payload = golden[f"{name}_payload"].tobytes()
        fmt, mcs, nss, ampdu = (int(x) for x in golden[f"{name}_meta"])
        cfg = from_reference(PhyConfig(Fmt(fmt), mcs, nss, len(payload),
                                       ampdu=bool(ampdu)))
        gold = PGTX.tx_waveform(cfg, payload, **_vht_kw(cfg))
        assert np.abs(gold - ref).max() < 2e-7, name
        got = eng.tx(cfg, [payload])
        assert got.shape == (1,) + ref.shape, name
        assert np.abs(got[0] - ref).max() < TOL_SU, name


def _golden_mu(golden):
    q = golden["mu_q"].astype(np.complex128)
    p0 = golden["mu_payload0"].tobytes()
    p1 = golden["mu_payload1"].tobytes()
    mcs0, mcs1, _, _, gid = (int(x) for x in golden["mu_meta"])
    mu = MuConfig((PhyConfig(Fmt.VHT, mcs0, 1, len(p0), ampdu=True),
                   PhyConfig(Fmt.VHT, mcs1, 1, len(p1), ampdu=True)),
                  group_id=gid)
    return mu, p0, p1, q


def test_tx_engine_golden_mu(golden):
    mu, p0, p1, q = _golden_mu(golden)
    got = PTX.TxEngine(device="cpu").tx_mu(from_reference(mu), [[p0], [p1]],
                                           q)
    assert got.shape == (1,) + golden["mu_sig"].shape
    assert np.abs(got[0] - golden["mu_sig"]).max() < TOL_MU


def _mu_case(rng, kind):
    a0, _ = _mk(rng, Fmt.VHT, 4, 1, n=100)
    a1, _ = _mk(rng, Fmt.VHT, 2, 1, n=57)
    mu = MuConfig((PhyConfig(Fmt.VHT, 4, 1, len(a0), ampdu=True),
                   PhyConfig(Fmt.VHT, 2, 1, len(a1), ampdu=True)),
                  group_id=2)
    if kind == "random":
        q = (rng.normal(size=(64, 2, 2)) + 1j * rng.normal(size=(64, 2, 2)))
        q /= np.sqrt(2)
    else:
        h = (rng.normal(size=(2, 2, 56)) + 1j * rng.normal(size=(2, 2, 56)))
        q = PSND.q_to_grid(PSND.zf_q(h / np.sqrt(2)))
    return mu, a0, a1, q


@pytest.mark.parametrize("kind", ["random", "zf"])
def test_tx_batch_mu_matches(kind):
    """Two users, three packets with different payloads and seeds, a
    random Q and a zero-forcing Q: ``tx_batch_mu`` and ``TxEngine.tx_mu``
    within 2e-5 of the reference's and of the gold model's waveform."""
    rng = np.random.default_rng(41)
    mu, a0, a1, q = _mu_case(rng, kind)
    pmu = from_reference(mu)
    pays = [[a0] + [bytes(rng.integers(0, 256, len(a0), dtype=np.uint8))
                    for _ in range(2)],
            [a1] + [bytes(rng.integers(0, 256, len(a1), dtype=np.uint8))
                    for _ in range(2)]]
    seeds = np.asarray([93, 5, 127], np.int32)
    arrs = [np.stack([np.frombuffer(p, np.uint8) for p in ps])
            for ps in pays]
    ref = _jax_wave(JTX.tx_batch_mu(mu, tuple(jnp.asarray(a) for a in arrs),
                                    jnp.asarray(seeds), from_host(q)))
    got = to_numpy(PTX.tx_batch_mu(
        pmu, tuple(torch.from_numpy(a) for a in arrs),
        torch.from_numpy(seeds), from_numpy_cf(q, "cpu")))
    assert got.shape == ref.shape == (3, 2, mu.n_samples)
    assert np.abs(got - ref).max() < TOL_MU
    for i in range(3):
        gold = PGTX.tx_waveform_mu(pmu, [pays[0][i], pays[1][i]], q,
                                   seed=int(seeds[i]))
        assert np.abs(got[i] - gold).max() < TOL_MU, i
    eng = PTX.TxEngine(device="cpu").tx_mu(pmu, pays, q, seeds=seeds)
    assert np.array_equal(eng, got.astype(np.complex64))
    ref_eng = JTX.TxEngine().tx_mu(mu, pays, q, seeds=seeds)
    assert np.abs(eng - ref_eng).max() < TOL_MU


def test_apply_q_grids_is_the_einsum():
    """The written-out contraction over the stream axis against numpy's
    complex einsum, for the preamble ("cjk") and the data ("bjnk") layouts;
    float32 products of at most 2 terms: 1e-6 of the operands' scale."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(64, 2, 2)) + 1j * rng.normal(size=(64, 2, 2))
    for sub, shape in (("cjk", (4, 2, 64)), ("bjnk", (3, 2, 5, 64))):
        g = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        want = np.einsum(f"kij,{sub}->{sub.replace('j', 'i')}", q, g)
        got = to_numpy(PTX._apply_q_grids(from_numpy_cf(g, "cpu"),
                                          from_numpy_cf(q, "cpu"), sub))
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-6 * np.abs(want).max() * 4


def test_tx_ndp():
    """A VHT 2-stream NDP (length 0, no data symbol) goes through
    ``tx_batch`` like any config: the preamble alone, equal to the
    reference's and the gold model's."""
    cfg = PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True)
    pcfg = from_reference(cfg)
    ref = JTX.TxEngine().tx(cfg, [b"", b""])
    got = PTX.TxEngine(device="cpu").tx(pcfg, [b"", b""])
    gold = PGTX.tx_waveform(pcfg, b"", group_id=0, partial_aid=0)
    assert got.shape == ref.shape == (2, 2, cfg.n_samples)
    assert np.abs(got - ref).max() < TOL_SU
    assert np.abs(got - gold[None]).max() < TOL_SU


def test_tx_engine_device_and_lengths():
    """The default device is the card and raises without one; a payload of
    the wrong length raises; constants are cached per config."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PTX.TxEngine()
    eng = PTX.TxEngine(device="cpu")
    cfg = from_reference(PhyConfig(Fmt.HT, 3, 1, 60))
    with pytest.raises(ValueError):
        eng.tx(cfg, [bytes(60), bytes(59)])
    eng.tx(cfg, [bytes(60)])
    assert PTX._static_parts(cfg, 0, 0) is PTX._static_parts(cfg, 0, 0)
    with pytest.raises(ValueError):
        PTX._static_parts_mu(from_reference(MuConfig(
            (PhyConfig(Fmt.VHT, 3, 2, 100, ampdu=True),
             PhyConfig(Fmt.VHT, 2, 1, 100, ampdu=True)), group_id=2)))
