"""Streams of VHT MU PPDUs as one station of a 2-user MU group hears them,
for the CPU tests of the port's MU station decode.  They are made with the
benchmark's frozen transmitter and sounding (``benchmark/generate_mu.py``,
``benchmark/reference/tx_mu.py``): a flat 2x2 channel I + 0.25 (N + jN),
ZF Q from both stations' NDP estimates at 30 dB, each PPDU's users at
their own MCS and A-MPDU, a CFO of its own, 30 dB AWGN.  A PPDU can be
altered on purpose: ``"sigb_tail"`` (the station's SIG-B sent with a tail
bit set, so it parses as rejected), ``"service"`` (its SERVICE field
carries a CRC that disagrees with its SIG-B), ``"data"`` (its data field
after the first symbol, which holds SERVICE, drowned in noise, so no
MPDU passes its FCS)."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from benchmark import generate as G
from benchmark import generate_2x2 as G2
from benchmark import generate_mu as GM
from benchmark.reference import mac, tx_mu

FS = 20e6
#: silent samples before each PPDU and after the last
GAP = 600
#: the L-LTF index the port's sync finds lies a few samples inside the
#: guard interval before the packet's first long symbol (160 + 32)
LTF_AT = 192


@dataclasses.dataclass
class Sent:
    start: int                  #: the PPDU's first sample in the stream
    group: int
    alter: str | None
    mcs: int = 0                #: the station's own user's
    length: int = 0             #: its A-MPDU's length
    nsym: int = 0
    mpdus: list = dataclasses.field(default_factory=list)
    cfo_hz: float = 0.0


@contextlib.contextmanager
def _sigb_altered(user, alter: str | None):
    """``tx_mu.vhtsigb_bits_mu`` altered for one user config object."""
    orig = tx_mu.vhtsigb_bits_mu

    def altered(ucfg):
        bits, crc = orig(ucfg)
        if ucfg is user and alter == "sigb_tail":
            bits = bits.copy()
            bits[20] ^= 1
        if ucfg is user and alter == "service":
            crc = crc.copy()
            crc[0] ^= 1
        return bits, crc
    tx_mu.vhtsigb_bits_mu = altered
    try:
        yield
    finally:
        tx_mu.vhtsigb_bits_mu = orig


def mu_stream(pos: int, seed: int, kinds=("own",) * 3, most_bytes=300,
              snr_db: float = 30.0, max_cfo_hz: float = 3e3):
    """One station's (N,) complex64 stream: the PPDUs of ``kinds`` in turn,
    each "own" (group 2), "foreign" (group 3, precoded for a channel
    drawn apart) or an alteration (group 2, see the module docstring);
    and the [Sent] records.  N is a multiple of 4096."""
    rng = np.random.default_rng(seed)
    h = G2.channel(rng, 0.25)
    q = GM.sounded_q(h, snr_db, rng)
    parts, sent, at = [], [], GAP
    for kind in kinds:
        users = [(int(rng.integers(0, 9)), int(rng.integers(100, most_bytes)),
                  int(rng.integers(1, 4))) for _ in range(2)]
        foreign = kind == "foreign"
        mu = GM.mu_cfg(("mu_own",) + tuple(users), 3 if foreign else 2)
        mpdus = [G._mpdus(None, [rng.integers(0, 256, b // m, dtype=np.uint8)
                                 .tobytes() for _ in range(m)])
                 for _, b, m in users]
        ams = [mac.ampdu_aggregate_vht(m) for m in mpdus]
        alter = None if kind in ("own", "foreign") else kind
        qq = GM.exact_q(G2.channel(rng, 0.25)) if foreign else q
        with _sigb_altered(mu.users[pos], alter):
            wave = GM._unit(h[pos] @ tx_mu.tx_waveform_mu(mu, ams, qq))
        if alter == "data":
            n = len(wave)
            d = n - 80 * (mu.nsym - 1)
            wave[d:] = 3.0 * (rng.standard_normal(n - d)
                              + 1j * rng.standard_normal(n - d))
        cfo = float(rng.uniform(-max_cfo_hz, max_cfo_hz))
        wave = wave * np.exp(2j * np.pi * cfo / FS * np.arange(len(wave)))
        u = mu.users[pos]
        sent.append(Sent(at, mu.group_id, alter, u.mcs, u.length, mu.nsym,
                         mpdus[pos], cfo))
        parts.append((at, wave))
        at += len(wave) + GAP
    n = -(-at // 4096) * 4096
    x = np.zeros(n, np.complex128)
    for a, w in parts:
        x[a: a + len(w)] += w
    x += GM._awgn(rng, n, snr_db)
    return x.astype(np.complex64), sent


def pair(results, sent: list[Sent]) -> dict:
    """sent index -> [results] whose start lies within 250 samples of the
    PPDU's L-LTF."""
    out: dict = {}
    for r in results:
        d = [abs(s.start + LTF_AT - r.start) for s in sent]
        j = int(np.argmin(d))
        if d[j] < 250:
            out.setdefault(j, []).append(r)
    return out
