"""Spec layer: IEEE 802.11a/n/ac (20 MHz, <=2 spatial streams) constant tables.

Everything here is *generated* from the standard's defining formulas (IEEE
802.11-2016 cl. 17/19/21) rather than typed out as literal tables, and is
validated against the reference implementation's golden vectors in
``tests/test_spec_parity.py``.

Reference parity targets (behavior, not code): ``lib/
cloud80211phy.cc:27-608`` (C tables) and ``tools/
phy80211header.py:580-761`` (PY-TB tables).

Layout convention used throughout this framework: a 20 MHz OFDM symbol is a
64-bin *fftshifted* spectrum vector ``grid[0..63]`` with bin ``i`` holding
subcarrier ``k = i - 32`` (k in [-32, 31]).  Time-domain modulation is
``ifft(ifftshift(grid))`` (numpy ifft normalization, 1/64), matching the PY-TB
``procFftMod`` semantics (phy80211header.py:958-964).
"""
from __future__ import annotations

import functools
import numpy as np

# ---------------------------------------------------------------------------
# Subcarrier layouts (20 MHz)
# ---------------------------------------------------------------------------

#: Pilot subcarriers (k values) for 20 MHz, all formats.
PILOT_K = np.array([-21, -7, 7, 21], dtype=np.int32)

#: Legacy (11a) data subcarriers: k in [-26, 26], excluding DC and pilots. 48 total.
DATA_K_L = np.array(
    [k for k in range(-26, 27) if k != 0 and k not in (-21, -7, 7, 21)],
    dtype=np.int32,
)

#: HT/VHT 20 MHz data subcarriers: k in [-28, 28], excluding DC and pilots. 52 total.
DATA_K_NL = np.array(
    [k for k in range(-28, 29) if k != 0 and k not in (-21, -7, 7, 21)],
    dtype=np.int32,
)

#: Occupied subcarriers including pilots (no DC).
OCC_K_L = np.array([k for k in range(-26, 27) if k != 0], dtype=np.int32)
OCC_K_NL = np.array([k for k in range(-28, 29) if k != 0], dtype=np.int32)

# Grid indices (into the 64-bin fftshifted grid).
DATA_IDX_L = DATA_K_L + 32
DATA_IDX_NL = DATA_K_NL + 32
PILOT_IDX = PILOT_K + 32
OCC_IDX_L = OCC_K_L + 32
OCC_IDX_NL = OCC_K_NL + 32

N_FFT = 20 * 64 // 20  # 64
N_GI = 16
N_SYM_SAMP = 80

# ---------------------------------------------------------------------------
# Training fields (frequency domain, defined on k in [-26,26] / [-28,28])
# ---------------------------------------------------------------------------


def _grid_from_k(kvals, vals) -> np.ndarray:
    g = np.zeros(64, dtype=np.complex128)
    g[np.asarray(kvals) + 32] = vals
    return g


# L-STF: 12 tones at multiples of 4, IEEE 802.11-2016 eq. 17-6.
_STF_POS = {
    -24: 1 + 1j, -20: -1 - 1j, -16: 1 + 1j, -12: -1 - 1j, -8: -1 - 1j, -4: 1 + 1j,
    4: -1 - 1j, 8: -1 - 1j, 12: 1 + 1j, 16: 1 + 1j, 20: 1 + 1j, 24: 1 + 1j,
}
#: L-STF 64-bin grid (before 1/sqrt(2) amplitude factor is *included* here).
STF_GRID = _grid_from_k(list(_STF_POS), np.array(list(_STF_POS.values())) * np.sqrt(0.5))

# L-LTF: k in [-26, 26], IEEE 802.11-2016 eq. 17-8.
_LTF_LEFT = [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1]
_LTF_RIGHT = [1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1, 1, 1]
LTF_L_GRID = _grid_from_k(range(-26, 27), np.array(_LTF_LEFT + [0] + _LTF_RIGHT, dtype=np.complex128))

# HT/VHT LTF (20 MHz): extends L-LTF to k in [-28, 28] (eq. 19-11 / 21-31).
LTF_NL_GRID = _grid_from_k(
    range(-28, 29),
    np.array([1, 1] + _LTF_LEFT + [0] + _LTF_RIGHT + [-1, -1], dtype=np.complex128),
)

#: P matrix for up to 4 LTFs (eq. 19-27); rows = space-time stream, cols = LTF index.
P_LTF = np.array(
    [[1, -1, 1, 1],
     [1, 1, -1, 1],
     [1, 1, 1, -1],
     [-1, 1, 1, 1]], dtype=np.int32)

#: R row (applied at pilot tones of VHT-LTF) = first row of P (21.3.8.3.5).
R_LTF = P_LTF[0]

#: VHT-SIG-B per-stream polarity for nSTS 4/7/8 (table 21-15).
P_SIGB_NSTS478 = np.array([1, 1, 1, -1, 1, 1, 1, -1], dtype=np.int32)

#: Number of non-legacy LTF symbols for nSTS 1..4 (table 19-12).
N_LTF_OF_NSTS = np.array([0, 1, 2, 4, 4], dtype=np.int32)

# ---------------------------------------------------------------------------
# Scramblers / pilot polarity (LFSR x^7 + x^4 + 1)
# ---------------------------------------------------------------------------


def lfsr_sequence(seed: int, n: int) -> np.ndarray:
    """Output bits of the 802.11 frame-synchronous scrambler (17.3.5.5).

    State is 7 bits; feedback = x7 xor x4; ``seed`` packs the initial state the
    same way the reference does (bit6..bit0 = x7..x1).
    """
    state = seed & 0x7F
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        fb = ((state >> 6) ^ (state >> 3)) & 1
        out[i] = fb
        state = ((state << 1) & 0x7E) | fb
    return out


@functools.lru_cache(maxsize=None)
def scramble_seq(seed: int, n: int = 127) -> np.ndarray:
    """One period (127) of the scrambler sequence for ``seed`` (cached)."""
    return lfsr_sequence(seed, n)


#: Pilot polarity sequence p_0..p_126 (17.3.5.10): the scrambler run from the
#: all-ones state, mapped 0 -> +1, 1 -> -1.
PILOT_POLARITY = (1 - 2 * lfsr_sequence(0x7F, 127).astype(np.int32))

#: Per-symbol base pilot values, legacy: [-21,-7,7,21] -> [1,1,1,-1] (eq 17-25).
PILOT_L = np.array([1, 1, 1, -1], dtype=np.int32)
#: VHT 20 MHz psi pattern (table 21-20), rotated left by one each symbol.
PILOT_VHT = np.array([1, 1, 1, -1], dtype=np.int32)
#: HT 20 MHz per-stream pilot patterns Psi_n (table 19-20): [nss][iss][n].
PILOT_HT20 = [
    np.array([[1, 1, 1, -1]], dtype=np.int32),
    np.array([[1, 1, -1, -1], [1, -1, -1, 1]], dtype=np.int32),
]

# ---------------------------------------------------------------------------
# QAM constellations (Gray mapped, 17.3.5.8 / tables 17-* )
# ---------------------------------------------------------------------------


def _gray_to_index(bits: np.ndarray) -> np.ndarray:
    """Inverse binary-reflected-Gray: bits (..., n) MSB-first -> integer."""
    out = bits[..., 0].astype(np.int64)
    acc = bits[..., 0].astype(np.int64)
    for i in range(1, bits.shape[-1]):
        acc = acc ^ bits[..., i]
        out = (out << 1) | acc
    return out


#: KMOD normalization per modulation order (sqrt of mean energy of the
#: unnormalized lattice): index by nBPSCS.
KMOD = {1: 1.0, 2: np.sqrt(2.0), 4: np.sqrt(10.0), 6: np.sqrt(42.0), 8: np.sqrt(170.0)}


@functools.lru_cache(maxsize=None)
def qam_table(nbpscs: int, qbpsk: bool = False) -> np.ndarray:
    """Constellation lookup: index = sum_j bit_j * 2^j (bit0 first in stream).

    For nbpscs > 1, the first half of the bits select the I level and the
    second half the Q level; each axis is binary-reflected-Gray mapped onto
    the odd lattice {-(2^m - 1), ..., 2^m - 1} and scaled by 1/KMOD.
    ``qbpsk`` gives the 90deg-rotated BPSK used by HT-SIG / VHT-SIG-A sym 2.
    """
    if nbpscs == 1:
        tab = np.array([-1.0, 1.0], dtype=np.complex128)
        return tab * 1j if qbpsk else tab
    assert not qbpsk
    m = nbpscs // 2
    idx = np.arange(1 << nbpscs)
    bits = (idx[:, None] >> np.arange(nbpscs)[None, :]) & 1  # bit j of index
    ibits = bits[:, :m]   # b0..b_{m-1}: I axis, b0 = MSB of the gray word
    qbits = bits[:, m:]
    ilev = 2 * _gray_to_index(ibits) - (2**m - 1)
    qlev = 2 * _gray_to_index(qbits) - (2**m - 1)
    return (ilev + 1j * qlev) / KMOD[nbpscs]


# ---------------------------------------------------------------------------
# BCC convolutional code (K=7, g0=133o, g1=171o) + puncturing (17.3.5.6)
# ---------------------------------------------------------------------------

#: Generator taps over (b_t, b_{t-1}, ..., b_{t-6}).
G0_TAPS = np.array([1, 0, 1, 1, 0, 1, 1], dtype=np.uint8)
G1_TAPS = np.array([1, 1, 1, 1, 0, 0, 1], dtype=np.uint8)

#: Puncture keep-patterns over the rate-1/2 coded stream (17.3.5.6).
PUNCTURE = {
    "1/2": np.array([1, 1], dtype=np.uint8),
    "2/3": np.array([1, 1, 1, 0], dtype=np.uint8),
    "3/4": np.array([1, 1, 1, 0, 0, 1], dtype=np.uint8),
    "5/6": np.array([1, 1, 1, 0, 0, 1, 1, 0, 0, 1], dtype=np.uint8),
}


# ---------------------------------------------------------------------------
# Interleavers (17.3.5.7 legacy; 19.3.11.8 / 21.3.10.8 non-legacy 20 MHz)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def interleave_perm_legacy(nbpscs: int) -> np.ndarray:
    """TX permutation for one legacy symbol: out[perm[k]] = in[k].

    nCBPS = 48 * nbpscs; 16 columns.
    """
    ncbps = 48 * nbpscs
    s = max(nbpscs // 2, 1)
    k = np.arange(ncbps)
    i = (ncbps // 16) * (k % 16) + k // 16
    j = s * (i // s) + (i + ncbps - (16 * i // ncbps)) % s
    return j.astype(np.int32)


@functools.lru_cache(maxsize=None)
def interleave_perm_nl(nbpscs: int, iss: int = 0, nss: int = 1) -> np.ndarray:
    """TX permutation for one non-legacy (52-tone) symbol stream.

    20 MHz: 13 columns, 4*nbpscs rows, rotation 11 for the second stream
    (frequency rotation term with J = 11 * nbpscs when nss >= 2).
    """
    ncbpss = 52 * nbpscs
    ncol, nrot = 13, 11
    s = max(nbpscs // 2, 1)
    k = np.arange(ncbpss)
    i = (4 * nbpscs) * (k % ncol) + k // ncol
    j = s * (i // s) + (i + ncbpss - (ncol * i // ncbpss)) % s
    if nss >= 2:
        rshift = ((iss * 2) % 3 + 3 * (iss // 3)) * nrot * nbpscs
        j = (j - rshift) % ncbpss
    return j.astype(np.int32)


@functools.lru_cache(maxsize=None)
def stream_parser_perm(nbpscs: int, nss: int, nes: int, ncbpss: int):
    """Stream-parser gather: for stream iss, index into the (single) encoder
    stream for each output bit position k of one symbol (21.3.10.6).

    Returns int32 array (nss, ncbpss): bit k of stream iss comes from encoder
    ``j = (k // s) % nes`` at position ``idx[iss, k]`` within that encoder's
    symbol block of ncbps/nes bits.  With nes == 1 (all 20 MHz <=2SS cases)
    the encoder index is always 0 and idx addresses the ncbps-bit block.
    """
    s = max(nbpscs // 2, 1)
    cs = nss * s
    k = np.arange(ncbpss)
    idx = np.empty((nss, ncbpss), dtype=np.int32)
    for iss in range(nss):
        idx[iss] = iss * s + cs * (k // (nes * s)) + (k % s)
    return idx


# ---------------------------------------------------------------------------
# CRC8 (SIG fields / A-MPDU delimiters) and CRC32 (FCS)
# ---------------------------------------------------------------------------


def crc8_bits(bits) -> np.ndarray:
    """CRC-8 (x^8+x^2+x+1), init all-ones, inverted, MSB-first output bits.

    Bit-serial definition per IEEE 802.11-2016 19.3.9.4.4; parity target of
    reference genBitBitCrc8 (phy80211header.py:87-100).
    """
    c = 0xFF
    for b in np.asarray(bits, dtype=np.uint8).tolist():
        fb = ((c >> 7) & 1) ^ int(b)
        # feedback taps into register bits 0, 1, 2 (poly x^8 + x^2 + x + 1)
        c = ((c << 1) & 0xFF) ^ (0b00000111 if fb else 0)
    out = (~c) & 0xFF
    # transmitted MSB (register bit 7) first, ones-complemented
    return np.array([(out >> (7 - i)) & 1 for i in range(8)], dtype=np.uint8)


CRC32_RESIDUE = 558161692  # value of crc32(mpdu || FCS) for a good frame


def bytes_to_bits(data: bytes | np.ndarray) -> np.ndarray:
    """LSB-first bit unpacking (802.11 bit transmission order)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return np.unpackbits(arr, bitorder="little")


def bits_to_bytes(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, dtype=np.uint8), bitorder="little").tobytes()


# ---------------------------------------------------------------------------
# Cyclic shift (CSD) phase ramps
# ---------------------------------------------------------------------------

#: Cyclic shift in ns for the legacy portion, [nss-1][iss] (table 21-10).
CSD_LEGACY_NS = np.array([[0, 0], [0, -200]], dtype=np.float64)
#: Cyclic shift for the non-legacy portion (table 21-11).
CSD_NL_NS = np.array([[0, 0], [0, -400]], dtype=np.float64)


def csd_phase(shift_ns: float, spr_mhz: float = 20.0) -> np.ndarray:
    """Per-bin phase ramp implementing a time cyclic shift on the 64-grid.

    Matches PY-TB procCSD (phy80211header.py:950-956): bin i (k = i-32) gets
    exp(-j*2*pi*shift_ns*spr*1e-3 * (i-32)/64).
    """
    i = np.arange(64)
    return np.exp(-1j * 2 * np.pi * shift_ns * spr_mhz * 1e-3 * (i - 32) / 64.0)


# Tone-field scaling constants (20 MHz): divide time samples by sqrt(nTF*nSS).
NTF_STF_L = 12
NTF_LTF_L = 52
NTF_SIG_L = 52
NTF_SIG_NL = 52   # HT-SIG / VHT-SIG-A ride the legacy 52-tone layout
NTF_STF_NL = 12
NTF_LTF_NL = 56
NTF_SIGB = 56
NTF_DATA_NL = 56
NTF_DATA_L = 52

#: VHT NDP SIG-B fixed bits, 20 MHz (table 21-16).
NDP_SIGB_20 = np.array([0, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
                       dtype=np.uint8)

#: VHT EOF padding subframe (4 octets as bits): eof=1, len=0, crc8, sig 0x4E.
def _vht_eof_bits() -> np.ndarray:
    head = np.zeros(16, dtype=np.uint8)
    head[0] = 1
    sig = np.array([(0x4E >> i) & 1 for i in range(8)], dtype=np.uint8)
    return np.concatenate([head, crc8_bits(head)[::1], sig])


VHT_EOF_BITS = _vht_eof_bits()
