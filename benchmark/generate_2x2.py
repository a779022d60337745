"""The two-antenna generator: a mix file of ``benchmark/traffic/`` in, the
two-row inputs of one run out, made from the run's seed.

The mix file has the groups of ``generate.py``'s, with the packet group
split by the number of spatial streams:

* ``packets``: ``streams`` weights one- and two-stream data packets
  ({"1": w1, "2": w2}); ``formats`` and ``mcs`` give, for each stream
  count, the formats' weights and each format's [lowest, highest] MCS
  (two-stream HT MCS are 8-15); ``payload_bytes``, ``ampdu_share``,
  ``ampdu_mpdus`` as in ``generate.py``; ``ndp_share`` the share of
  2-stream VHT NDPs.
* ``layout``: as in ``generate.py`` ("blocks").
* ``channel``: ``snr_db`` of complex AWGN on each antenna against the
  packet's mean power per antenna, and ``coupling`` c: each packet is
  seen through its own flat 2 x 2 channel H = I + c (N + jN), N standard
  normal (a one-stream packet through H's first column), drawn from the
  mix's ``shape_seed`` with the packet, so every seed offers the same
  channels.

The seeds work as in ``generate.py``: ``shape_seed`` fixes each block's
packets (formats, MCS, sizes, gaps, channels) and the packet that crosses
into the next block; the run's seed orders the other packets within each
block and draws every payload byte and the noise.  Waveforms come from
the frozen numpy transmitter (``reference/tx.py``), never from the
program under test; MAC frames, A-MPDUs, addresses, margins and the
block-placement rule are ``generate.py``'s.
"""
from __future__ import annotations

import numpy as np

from . import generate as G
from .reference import tx
from .reference.params import Fmt, PhyConfig


def draw_spec(p: dict, rng: np.random.Generator) -> tuple:
    """One packet's (fmt, mcs, n_bytes, n_mpdus, nss); n_bytes 0 is an
    NDP."""
    if rng.random() < p.get("ndp_share", 0.0):
        return (int(Fmt.VHT), 0, 0, 1, 2)
    ns = sorted(p["streams"])
    w = np.array([p["streams"][n] for n in ns], float)
    nss = ns[int(rng.choice(len(ns), p=w / w.sum()))]
    names = sorted(p["formats"][nss])
    w = np.array([p["formats"][nss][n] for n in names], float)
    name = names[int(rng.choice(len(names), p=w / w.sum()))]
    lo, hi = p["mcs"][nss][name]
    mcs = int(rng.integers(lo, hi + 1))
    n_mpdus = 1
    if name != "L" and rng.random() < p.get("ampdu_share", 0.0):
        a, b = p["ampdu_mpdus"]
        n_mpdus = int(rng.integers(a, b + 1))
    lo, hi = p["payload_bytes"]
    return (int(G.FMTS[name]), mcs, int(rng.integers(lo, hi + 1)), n_mpdus,
            int(nss))


def spec_cfg(spec: tuple) -> PhyConfig:
    """The transmit vector of a spec (its length depends on sizes only)."""
    fmt, mcs, n_bytes, n_mpdus, nss = spec
    if n_bytes == 0:
        return PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True)
    size = n_bytes // n_mpdus
    psdu, agg = G._psdu(Fmt(fmt), G._mpdus(spec, [bytes(size)] * n_mpdus))
    return PhyConfig(Fmt(fmt), mcs, nss, len(psdu), ampdu=agg)


def channel(rng: np.random.Generator, coupling: float) -> np.ndarray:
    """A flat 2 x 2 channel I + c (N + jN)."""
    n = rng.standard_normal((2, 2, 2))
    return np.eye(2) + coupling * (n[..., 0] + 1j * n[..., 1])


def synth(item: tuple) -> tuple[np.ndarray, list[bytes]]:
    """(spec, payloads, H) -> ((2, n) complex64 waveform at the antennas,
    of unit mean power per antenna, the MPDUs sent).  Runs in the
    generator's worker processes."""
    spec, payloads, h = item
    cfg = spec_cfg(spec)
    if cfg.is_ndp:
        wave = tx.tx_waveform(cfg, b"", group_id=0, partial_aid=0)
        mpdus = []
    else:
        mpdus = G._mpdus(spec, payloads)
        psdu, _ = G._psdu(cfg.fmt, mpdus)
        kw = {"group_id": 0, "partial_aid": 0} if cfg.fmt == Fmt.VHT else {}
        wave = tx.tx_waveform(cfg, psdu, **kw)
    rx = np.asarray(h)[:, : wave.shape[0]] @ wave
    rx = rx / np.sqrt(np.mean(np.abs(rx) ** 2))
    return rx.astype(np.complex64), mpdus


def block_shapes(tr: dict, geo: dict) -> list[dict]:
    """Each block's fixed packets, from the mix's ``shape_seed``, by
    ``generate.block_shapes``'s placement rule: ``inner`` [(spec, gap, H)]
    inside the block's own span in any order, ``cross`` the one placed
    after them that may end in the halo (or None), ``first`` the first
    free sample."""
    lay, p = tr["layout"], tr["packets"]
    B, H = geo["owned_samples"], geo["halo_samples"]
    g0, g1 = lay["gap_samples"]
    c = tr["channel"]["coupling"]
    rng = np.random.default_rng(tr["shape_seed"])
    out, first = [], 0
    for _ in range(lay["n_blocks"]):
        inner, end, cross = [], first, None
        while True:
            spec = draw_spec(p, rng)
            gap = int(rng.integers(g0, g1 + 1))
            h = channel(rng, c)
            n = spec_cfg(spec).n_samples
            if end + gap + n <= B - G.OWN_MARGIN:
                inner.append((spec, gap, h))
                end += gap + n
                continue
            if (end + gap < B - G.OWN_MARGIN
                    and end + gap + n <= B + H - G.HALO_MARGIN):
                cross = (spec, gap, h)
                end += gap + n
            break
        out.append({"inner": inner, "cross": cross, "first": first})
        first = max(0, end - B)
    return out


def make_blocks(tr: dict, geo: dict, seed: int, pool) -> dict:
    """The inputs of a two-antenna "blocks" mix: ``views`` [(2, LCTX +
    BLOCK + HALO) complex64] one per block, and ``sent`` [[(start in the
    view, fields)]] the packets each block owns; fields as
    ``generate.make_blocks``'s, with the packet's ``length`` and ``ampdu``
    (its transmit vector) besides."""
    p = tr["packets"]
    B, H, L = (geo["owned_samples"], geo["halo_samples"],
               geo["left_context_samples"])
    shapes = block_shapes(tr, geo)
    rng = np.random.default_rng(seed)
    placed, items = [], []
    for k, sh in enumerate(shapes):
        order = rng.permutation(len(sh["inner"]))
        seq = [sh["inner"][i] for i in order]
        if sh["cross"] is not None:
            seq.append(sh["cross"])
        pos = k * B + sh["first"]
        for spec, gap, h in seq:
            pos += gap
            size = spec[2] // spec[3]
            pls = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
                   for _ in range(spec[3])]
            items.append((spec, pls, h))
            placed.append((k, pos, spec))
            pos += spec_cfg(spec).n_samples
    waves = pool.map(synth, items, chunksize=8)
    n_total = len(shapes) * B + H
    x = np.zeros((2, n_total), np.complex64)
    sent = [[] for _ in shapes]
    for (k, pos, spec), (wave, mpdus) in zip(placed, waves):
        x[:, pos: pos + wave.shape[-1]] += wave
        cfg = spec_cfg(spec)
        fields = {"fmt": spec[0], "mcs": spec[1], "nss": cfg.nss,
                  "is_ndp": spec[2] == 0, "mpdus": mpdus,
                  "length": cfg.length, "ampdu": cfg.ampdu}
        sent[k].append((pos - k * B + L, fields))
    amp = 10 ** (-tr["channel"]["snr_db"] / 20) / np.sqrt(2)
    x += (amp * rng.standard_normal((2, n_total), np.float32)).astype(
        np.complex64)
    x += (1j * amp * rng.standard_normal((2, n_total), np.float32)).astype(
        np.complex64)
    lead = np.concatenate([np.zeros((2, L), np.complex64), x], axis=1)
    views = [lead[:, k * B: k * B + L + B + H].copy()
             for k in range(len(shapes))]
    return {"views": views, "sent": sent}


def make(tr: dict, cfg: dict, seed: int, pool) -> dict:
    """Inputs of one run of two-antenna mix ``tr`` for configuration
    ``cfg`` from ``seed``."""
    if tr["layout"]["kind"] != "blocks" or cfg["nrx"] != 2:
        raise ValueError("generate_2x2 makes two-row blocks only")
    return make_blocks(tr, cfg["blocks"], seed, pool)
