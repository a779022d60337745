"""The one traffic generator: a mix file of ``benchmark/traffic/`` in,
the inputs of one run out, made from the run's seed.

A mix file is JSON with three groups of parameters:

* ``packets``: what one packet is.  ``formats`` weights the formats
  ("L", "HT", "VHT"); ``mcs`` gives each format's [lowest, highest] MCS;
  ``payload_bytes`` the [least, most] bytes of MAC payload a packet
  carries (split evenly over its MPDUs); ``ampdu_share`` the share of HT
  and VHT packets sent as A-MPDUs of ``ampdu_mpdus`` = [least, most]
  MPDUs; ``ndp_share`` the share of 2-stream VHT NDPs, seen through the
  fixed 1 x 2 channel ``ndp_channel`` ([[re, im], [re, im]]);
  ``payload_pool`` (optional) draws every payload from that many distinct
  ones.
* ``layout``: ``kind`` "blocks" lays ``n_blocks`` rx-daemon blocks, each
  of the configuration's ``blocks`` geometry (``owned_samples``, a
  ``halo_samples`` look-ahead, ``left_context_samples`` of the block
  before), with ``gap_samples`` = [least, most] silent samples before
  each packet.
* ``channel``: ``snr_db`` of complex AWGN against each packet's unit rms.

Two seeds are at work.  ``shape_seed`` in the file fixes each block's set
of packets (formats, MCS, sizes, gaps) and the packet that crosses into
the next block, so every run offers the same work.  The run's seed orders
the other packets within each block and draws every payload byte and the
noise.  Waveforms come from the frozen numpy transmitter beside this file
(``reference/tx.py``), never from the program under test.
"""
from __future__ import annotations

import numpy as np

from .reference import mac, tx
from .reference.params import Fmt, PhyConfig

#: MAC addresses of the data frames (receiver, transmitter, BSSID)
ADDR = ("02:00:00:00:00:01", "02:00:00:00:00:02", "02:00:00:00:00:01")
#: a packet's first sample lies this far before the end of its block's own
#: span at the latest, and its last this far before the end of the halo
OWN_MARGIN, HALO_MARGIN = 1000, 2000
FMTS = {"L": Fmt.L, "HT": Fmt.HT, "VHT": Fmt.VHT}


def draw_spec(p: dict, rng: np.random.Generator) -> tuple:
    """One packet's (fmt, mcs, n_bytes, n_mpdus); n_bytes 0 is an NDP."""
    if rng.random() < p.get("ndp_share", 0.0):
        return (int(Fmt.VHT), 0, 0, 1)
    names = sorted(p["formats"])
    w = np.array([p["formats"][n] for n in names], float)
    name = names[int(rng.choice(len(names), p=w / w.sum()))]
    lo, hi = p["mcs"][name]
    mcs = int(rng.integers(lo, hi + 1))
    n_mpdus = 1
    if name != "L" and rng.random() < p.get("ampdu_share", 0.0):
        a, b = p["ampdu_mpdus"]
        n_mpdus = int(rng.integers(a, b + 1))
    lo, hi = p["payload_bytes"]
    return (int(FMTS[name]), mcs, int(rng.integers(lo, hi + 1)), n_mpdus)


def _psdu(fmt: Fmt, mpdus: list[bytes]) -> tuple[bytes, bool]:
    if fmt == Fmt.VHT:
        return mac.ampdu_aggregate_vht(mpdus), True
    if len(mpdus) > 1:
        return mac.ampdu_aggregate_ht(mpdus), True
    return mpdus[0], False


def _mpdus(spec: tuple, payloads: list[bytes]) -> list[bytes]:
    return [mac.qos_data_frame(pl, *ADDR, k) for k, pl in enumerate(payloads)]


def spec_cfg(spec: tuple) -> PhyConfig:
    """The transmit vector of a spec (its length depends on sizes only)."""
    fmt, mcs, n_bytes, n_mpdus = spec
    if n_bytes == 0:
        return PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True)
    size = n_bytes // n_mpdus
    psdu, agg = _psdu(Fmt(fmt), _mpdus(spec, [bytes(size)] * n_mpdus))
    return PhyConfig(Fmt(fmt), mcs, 1, len(psdu), ampdu=agg)


def synth(item: tuple) -> tuple[np.ndarray, list[bytes]]:
    """(spec, payloads, ndp channel) -> (unit-rms complex64 waveform (n,),
    the MPDUs sent).  Runs in the generator's worker processes."""
    spec, payloads, chan = item
    cfg = spec_cfg(spec)
    if cfg.is_ndp:
        wave = (np.asarray(chan)[None, :] @ tx.tx_waveform(
            cfg, b"", group_id=0, partial_aid=0))[0]
        mpdus = []
    else:
        mpdus = _mpdus(spec, payloads)
        psdu, _ = _psdu(cfg.fmt, mpdus)
        kw = {"group_id": 0, "partial_aid": 0} if cfg.fmt == Fmt.VHT else {}
        wave = tx.tx_waveform(cfg, psdu, **kw)[0]
    wave = wave / np.sqrt(np.mean(np.abs(wave) ** 2))
    return wave.astype(np.complex64), mpdus


def block_shapes(tr: dict, geo: dict) -> list[dict]:
    """Each block's fixed packets, from the mix's ``shape_seed``: ``inner``
    [(spec, gap)] packets that lie inside the block's own span in any
    order, ``cross`` the (spec, gap) placed after them that may end in the
    halo (or None), and ``first`` the first free sample (offsets from the
    block's start; a packet crossing from the block before ends there)."""
    lay, p = tr["layout"], tr["packets"]
    B, H = geo["owned_samples"], geo["halo_samples"]
    g0, g1 = lay["gap_samples"]
    rng = np.random.default_rng(tr["shape_seed"])
    out, first = [], 0
    for _ in range(lay["n_blocks"]):
        inner, end, cross = [], first, None
        while True:
            spec = draw_spec(p, rng)
            gap = int(rng.integers(g0, g1 + 1))
            n = spec_cfg(spec).n_samples
            if end + gap + n <= B - OWN_MARGIN:
                inner.append((spec, gap))
                end += gap + n
                continue
            if (end + gap < B - OWN_MARGIN
                    and end + gap + n <= B + H - HALO_MARGIN):
                cross = (spec, gap)
                end += gap + n
            break
        out.append({"inner": inner, "cross": cross, "first": first})
        first = max(0, end - B)
    return out


def make_blocks(tr: dict, geo: dict, seed: int, pool) -> dict:
    """The inputs of a "blocks" mix: ``views`` [(1, LCTX + BLOCK + HALO)
    complex64] one per block, as a daemon hands them to the engine (left
    context zero before block 0), and ``sent`` [[(start in the view,
    fields)]] the packets each block owns."""
    p = tr["packets"]
    B, H, L = (geo["owned_samples"], geo["halo_samples"],
               geo["left_context_samples"])
    shapes = block_shapes(tr, geo)
    rng = np.random.default_rng(seed)
    pool_pl = None
    if p.get("payload_pool"):
        lo, hi = p["payload_bytes"]
        pool_pl = [rng.integers(0, 256, hi, dtype=np.uint8).tobytes()
                   for _ in range(p["payload_pool"])]
    chan = [complex(re, im) for re, im in p.get("ndp_channel", [[1, 0]])]
    placed, items = [], []
    for k, sh in enumerate(shapes):
        order = rng.permutation(len(sh["inner"]))
        seq = [sh["inner"][i] for i in order]
        if sh["cross"] is not None:
            seq.append(sh["cross"])
        pos = k * B + sh["first"]
        for spec, gap in seq:
            pos += gap
            size = spec[2] // spec[3]
            if pool_pl is not None:
                j = int(rng.integers(0, len(pool_pl)))
                pls = [pool_pl[j][:size]] * spec[3]
            else:
                pls = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
                       for _ in range(spec[3])]
            items.append((spec, pls, chan))
            placed.append((k, pos, spec))
            pos += spec_cfg(spec).n_samples
    waves = pool.map(synth, items, chunksize=8)
    n_total = len(shapes) * B + H
    x = np.zeros(n_total, np.complex64)
    sent = [[] for _ in shapes]
    for (k, pos, spec), (wave, mpdus) in zip(placed, waves):
        x[pos: pos + wave.shape[-1]] += wave
        fields = {"fmt": spec[0], "mcs": spec[1], "nss": 2 if spec[2] == 0
                  else 1, "is_ndp": spec[2] == 0, "mpdus": mpdus}
        sent[k].append((pos - k * B + L, fields))
    amp = 10 ** (-tr["channel"]["snr_db"] / 20) / np.sqrt(2)
    x += (amp * rng.standard_normal(n_total, np.float32)).astype(np.complex64)
    x += (1j * amp * rng.standard_normal(n_total, np.float32)).astype(
        np.complex64)
    lead = np.concatenate([np.zeros(L, np.complex64), x])
    views = [lead[k * B: k * B + L + B + H][None].copy()
             for k in range(len(shapes))]
    return {"views": views, "sent": sent}


def make(tr: dict, cfg: dict, seed: int, pool) -> dict:
    """Inputs of one run of mix ``tr`` for configuration ``cfg`` from
    ``seed``; ``pool`` maps the synthesis over worker processes."""
    if tr["layout"]["kind"] != "blocks":
        raise ValueError(f"unknown layout {tr['layout']['kind']!r}")
    return make_blocks(tr, cfg["blocks"], seed, pool)
