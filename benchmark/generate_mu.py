"""The MU-MIMO station's generator: a mix file of ``benchmark/traffic/`` in,
the one-row inputs of one run out, as the station at position ``mu_pos``
of the configuration's engine hears its AP, made from the run's seed.

The AP has two antennas and serves two stations of one stream each
(GR-WiFi's ``tools/cmu_v3``).  The mix file has three groups:

* ``packets``: ``kinds`` weights the four kinds of packet: ``mu_own``,
  a VHT MU PPDU of the station's group (``mu_gid``); ``mu_foreign``, one
  of ``foreign_gid``, which the station must not report; ``ndp``, a
  2-stream VHT NDP (it opens a sounding round, below); ``su``, one-stream
  SU data sent from AP antenna 0.  ``mu`` gives each MU user's [lowest,
  highest] ``mcs``, its ``payload_bytes`` = [least, most] in all and its
  A-MPDU of ``mpdus`` = [least, most] MPDUs (every user draws its own);
  ``su`` the SU packets' ``formats``, ``mcs``, ``payload_bytes``,
  ``ampdu_share`` and ``ampdu_mpdus`` as ``generate.py`` reads them.
* ``layout``: as in ``generate.py`` ("blocks").
* ``channel``: ``snr_db`` of complex AWGN at the station against each
  packet's unit rms, and ``coupling`` c of the flat 2 x 2 AP-to-stations
  channel H = I + c (N + jN), N standard normal; row u is station u's.

**Sounding rounds.**  The stream opens in round 0, and each NDP opens the
next round.  A round's channel H is drawn from the mix's ``shape_seed``
(round by round, so every seed sees the same channels).  In each round the
AP sounds both stations with an NDP; each station's estimate of its row is
made by the frozen numpy receiver (``reference/rx.py``) from that station's
own reception of the NDP, at ``snr_db`` and with noise from the run's seed,
and fed back raw (``reference/tx_mu.feedback_from_ndp``); Q is the ZF
precoder of the two rows (cmu_v3's raw-H feedback, so the CSI is as
imperfect as a deployment's).  The station's own row of H carries the
round's NDPs, MU PPDUs of its group (precoded by the round's Q) and SU
packets (H's column of antenna 0) to it.  A ``mu_foreign`` PPDU is
precoded for another pair of stations, by the exact ZF of a channel drawn
apart for it (from ``shape_seed``), and heard through the station's row.

The seeds work as in ``generate.py``: ``shape_seed`` fixes each block's
packets (kinds, MCS, sizes, gaps) and the packet that crosses into the
next block, and the rounds' and the foreign PPDUs' channels; the run's
seed orders the other packets within each block (so which round a packet
falls in), draws every payload byte, the noise and the stations' CSI
noise.  Waveforms come from the frozen numpy transmitter
(``reference/tx.py``, ``reference/tx_mu.py``), never from the program
under test; MAC frames, A-MPDUs, addresses, margins and the placement
rule are ``generate.py``'s.
"""
from __future__ import annotations

import numpy as np

from . import generate as G
from . import generate_2x2 as G2
from .reference import mac, tx, tx_mu
from .reference import rx as GRX
from .reference.params import Fmt, MuConfig, PhyConfig

KINDS = ("mu_own", "mu_foreign", "ndp", "su")
#: an NDP's L-LTF (its first long symbol) starts this far into the packet
NDP_LTF = 160 + 32
#: samples of an NDP the estimate reads from its L-LTF index: to the end
#: of its two VHT-LTFs
NDP_SPAN = 128 + 80 + 160 + 80 + 160


def _user(p: dict, rng: np.random.Generator) -> tuple:
    lo, hi = p["mcs"]
    a, b = p["mpdus"]
    n0, n1 = p["payload_bytes"]
    return (int(rng.integers(lo, hi + 1)), int(rng.integers(n0, n1 + 1)),
            int(rng.integers(a, b + 1)))


def draw_spec(p: dict, rng: np.random.Generator) -> tuple:
    """One packet: ("ndp",), ("su", fmt, mcs, n_bytes, n_mpdus) or
    (kind, (mcs, n_bytes, n_mpdus) of user 0, ... of user 1)."""
    w = np.array([p["kinds"].get(k, 0.0) for k in KINDS], float)
    kind = KINDS[int(rng.choice(len(KINDS), p=w / w.sum()))]
    if kind == "ndp":
        return ("ndp",)
    if kind == "su":
        return ("su",) + G.draw_spec(dict(p["su"], ndp_share=0.0), rng)
    return (kind, _user(p["mu"], rng), _user(p["mu"], rng))


def _ampdu(user: tuple) -> bytes:
    _, n_bytes, n_mpdus = user
    size = n_bytes // n_mpdus
    return mac.ampdu_aggregate_vht([mac.qos_data_frame(
        bytes(size), *G.ADDR, k) for k in range(n_mpdus)])


def mu_cfg(spec: tuple, gid: int) -> MuConfig:
    """The transmit vector of an MU spec (its lengths depend on sizes
    only)."""
    return MuConfig(tuple(PhyConfig(Fmt.VHT, u[0], 1, len(_ampdu(u)),
                                    ampdu=True) for u in spec[1:]),
                    group_id=gid)


def n_samples(spec: tuple) -> int:
    if spec[0] == "ndp":
        return PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True).n_samples
    if spec[0] == "su":
        return G.spec_cfg(spec[1:]).n_samples
    return mu_cfg(spec, 0).n_samples


def block_shapes(tr: dict, geo: dict) -> tuple[list[dict], list]:
    """(blocks, rounds) from the mix's ``shape_seed``.  Each block's fixed
    packets, by ``generate.block_shapes``'s placement rule: ``inner``
    [(spec, gap, foreign H or None)] inside the block's own span in any
    order, ``cross`` the one placed after them that may end in the halo
    (or None), ``first`` the first free sample.  ``rounds``: the channel
    H of each sounding round (round 0, then one an NDP)."""
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
            h = G2.channel(rng, c) if spec[0] == "mu_foreign" else None
            n = n_samples(spec)
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
    n_ndp = sum(1 for sh in out for s, _, _ in sh["inner"]
                + ([sh["cross"]] if sh["cross"] else []) if s[0] == "ndp")
    rounds = [G2.channel(rng, c) for _ in range(1 + n_ndp)]
    return out, rounds


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.sqrt(np.mean(np.abs(x) ** 2))


def _awgn(rng: np.random.Generator, shape, snr_db: float) -> np.ndarray:
    amp = 10 ** (-snr_db / 20) / np.sqrt(2)
    return (amp * rng.standard_normal(shape, np.float32)).astype(
        np.complex64) + (1j * amp * rng.standard_normal(
            shape, np.float32)).astype(np.complex64)


def sounded_q(h: np.ndarray, snr_db: float,
              rng: np.random.Generator) -> np.ndarray:
    """One sounding round: each station's reception of an NDP through its
    row of ``h`` at ``snr_db``, its estimate by the frozen receiver at the
    true L-LTF index, its raw feedback; the ZF Q grid (64, 2, 2)."""
    ndp = tx.tx_waveform(PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True), b"",
                         group_id=0, partial_aid=0)
    rows = []
    for u in range(2):
        x = _unit(h[u] @ ndp)
        x = (x + _awgn(rng, x.shape, snr_db)).astype(np.complex128)
        xs = GRX.derotate(x, NDP_LTF, NDP_SPAN, 0.0)[None]
        est = GRX.nl_chan_est(GRX._nl_ltf_grids(xs, 448, 2), 2, Fmt.VHT)
        rows.append(tx_mu.feedback_from_ndp(est)[0])
    return tx_mu.q_to_grid(tx_mu.zf_q(np.stack(rows)))


def exact_q(h: np.ndarray) -> np.ndarray:
    """The ZF Q grid of a channel known exactly (flat over the tones)."""
    return tx_mu.q_to_grid(tx_mu.zf_q(np.repeat(h[:, :, None], 56, axis=2)))


def synth(item: tuple) -> tuple[np.ndarray, list[bytes]]:
    """(spec, group id, each user's payloads, Q or None, the station's
    row (2,), the station's position) -> (the (n,) complex64 waveform at
    the station, of unit rms; the MPDUs sent to it).  Runs in the
    generator's worker processes."""
    spec, gid, payloads, q, row, pos = item
    if spec[0] == "ndp":
        wave = row @ tx.tx_waveform(PhyConfig(Fmt.VHT, 0, 2, 0, ampdu=True),
                                    b"", group_id=0, partial_aid=0)
        mine = []
    elif spec[0] == "su":
        mine = G._mpdus(spec[1:], payloads[0])
        cfg = G.spec_cfg(spec[1:])
        psdu, _ = G._psdu(cfg.fmt, mine)
        kw = {"group_id": 0, "partial_aid": 0} if cfg.fmt == Fmt.VHT else {}
        wave = row[0] * tx.tx_waveform(cfg, psdu, **kw)[0]
    else:
        mpdus = [G._mpdus(spec, pl) for pl in payloads]
        ams = [mac.ampdu_aggregate_vht(m) for m in mpdus]
        wave = row @ tx_mu.tx_waveform_mu(mu_cfg(spec, gid), ams, q)
        mine = mpdus[pos]
    return _unit(wave).astype(np.complex64), mine


def make_blocks(tr: dict, cfg: dict, seed: int, pool) -> dict:
    """The inputs of an MU-station "blocks" mix: ``views`` [(1, LCTX +
    BLOCK + HALO) complex64] one per block, ``sent`` [[(start in the view,
    fields)]] the packets each block owns that are addressed to the
    station (fields as ``generate_2x2.make_blocks``'s; an MU PPDU's are
    the station's own user's: its MCS, streams, MPDUs and A-MPDU length,
    with ``mu`` True, the PPDU's ``nsym`` and ``nsts_total``, and
    ``own_stream``, the user's first space-time stream), and ``foreign``
    [[start in the view]] the other group's MU PPDUs each block owns."""
    p, geo = tr["packets"], cfg["blocks"]
    pos, gid = cfg["engine"]["mu_pos"], cfg["engine"]["mu_gid"]
    B, H, L = (geo["owned_samples"], geo["halo_samples"],
               geo["left_context_samples"])
    snr = tr["channel"]["snr_db"]
    shapes, rounds = block_shapes(tr, geo)
    rng = np.random.default_rng(seed)
    r = 0
    qs = [sounded_q(rounds[0], snr, rng)]
    placed, items = [], []
    for k, sh in enumerate(shapes):
        order = rng.permutation(len(sh["inner"]))
        seq = [sh["inner"][i] for i in order]
        if sh["cross"] is not None:
            seq.append(sh["cross"])
        at = k * B + sh["first"]
        for spec, gap, hf in seq:
            at += gap
            if spec[0] == "ndp":
                r += 1
                qs.append(sounded_q(rounds[r], snr, rng))
            if spec[0] == "su":
                n_bytes, n_mpdus = spec[3], spec[4]
                pls = [[rng.integers(0, 256, n_bytes // n_mpdus,
                                     dtype=np.uint8).tobytes()
                        for _ in range(n_mpdus)]]
            elif spec[0] == "ndp":
                pls = []
            else:
                pls = [[rng.integers(0, 256, u[1] // u[2],
                                     dtype=np.uint8).tobytes()
                        for _ in range(u[2])] for u in spec[1:]]
            foreign = spec[0] == "mu_foreign"
            q = exact_q(hf) if foreign else qs[r]
            g = tr["packets"]["mu"]["foreign_gid"] if foreign else gid
            items.append((spec, g, pls, q, rounds[r][pos], pos))
            placed.append((k, at, spec))
            at += n_samples(spec)
    waves = pool.map(synth, items, chunksize=8)
    n_total = len(shapes) * B + H
    x = np.zeros(n_total, np.complex64)
    sent = [[] for _ in shapes]
    foreign = [[] for _ in shapes]
    for (k, at, spec), (wave, mine) in zip(placed, waves):
        x[at: at + wave.shape[-1]] += wave
        start = at - k * B + L
        if spec[0] == "mu_foreign":
            foreign[k].append(start)
            continue
        if spec[0] == "ndp":
            f = {"fmt": int(Fmt.VHT), "mcs": 0, "nss": 2, "is_ndp": True,
                 "mpdus": [], "length": 0, "ampdu": True}
        elif spec[0] == "su":
            c = G.spec_cfg(spec[1:])
            f = {"fmt": int(c.fmt), "mcs": c.mcs, "nss": 1, "is_ndp": False,
                 "mpdus": mine, "length": c.length, "ampdu": c.ampdu}
        else:
            mu = mu_cfg(spec, gid)
            u = mu.users[pos]
            f = {"fmt": int(Fmt.VHT), "mcs": u.mcs, "nss": u.nss,
                 "is_ndp": False, "mpdus": mine, "length": u.length,
                 "ampdu": True, "mu": True, "nsym": mu.nsym,
                 "nsts_total": mu.nss_total,
                 "own_stream": sum(v.nss for v in mu.users[:pos])}
        sent[k].append((start, f))
    x += _awgn(rng, n_total, snr)
    lead = np.concatenate([np.zeros(L, np.complex64), x])
    views = [lead[k * B: k * B + L + B + H][None].copy()
             for k in range(len(shapes))]
    return {"views": views, "sent": sent, "foreign": foreign}


def make(tr: dict, cfg: dict, seed: int, pool) -> dict:
    """Inputs of one run of MU-station mix ``tr`` for configuration
    ``cfg`` (one antenna; the station's ``mu_pos`` and ``mu_gid`` are its
    engine's) from ``seed``."""
    if tr["layout"]["kind"] != "blocks" or cfg["nrx"] != 1:
        raise ValueError("generate_mu makes one-row blocks only")
    return make_blocks(tr, cfg, seed, pool)
