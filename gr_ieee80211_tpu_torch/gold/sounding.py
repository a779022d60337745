"""MU-MIMO sounding: NDP channel feedback, compressed beamforming report
(Givens rotation quantization), and zero-forcing spatial mapping Q.

Behavioral counterpart of the reference's sounding stack:
``tools/phy80211header.py:1217-1362`` (feedback + pilot
interpolation), ``tools/phy80211.py:1179-1326`` (V compression),
``tools/mac80211header.py:262-557`` (quantization + recovery), and
``tools/cmu_ap.py:131-151`` (ZF Q).  The ZF here is the textbook right
inverse (H Q = I) rather than the demo's transposed variant; the closed-loop
MU test in tests/test_mu_loop.py validates user separation end-to-end.
"""
from __future__ import annotations

import numpy as np

from ..spec import tables as T


# ---------------------------------------------------------------------------
# Channel feedback from an NDP channel estimate
# ---------------------------------------------------------------------------

def interp_pilot_tones(h_data: np.ndarray) -> np.ndarray:
    """Interpolate the 4 pilot tones from neighbors: (..., 52) -> (..., 56).

    Mag/phase linear interpolation between the adjacent data tones, matching
    the reference's procVhtPilotChanIntpo semantics.
    """
    mag = np.abs(h_data)
    ph = np.angle(h_data)

    def mid(i, j):
        # wrap-aware phase midpoint: a sync-offset timing ramp rotates
        # >2 rad/tone, so naive angle averaging flips by pi whenever one
        # antenna's angle wraps across +-pi and the other's does not
        # (observed: garbage pilot directions in the compressed-V loop)
        d = ph[..., j: j + 1] - ph[..., i: i + 1]
        d = d - 2 * np.pi * np.round(d / (2 * np.pi))
        m = (mag[..., i: i + 1] + mag[..., j: j + 1]) / 2
        return m * np.exp(1j * (ph[..., i: i + 1] + d / 2))

    # occupied NL tone order: data-only (52) -> with pilots (56); pilot p sits
    # between data indices: after 7, 20, 32, 44 (positions 7,21,34,48 in 56)
    return np.concatenate([
        h_data[..., 0:7], mid(6, 7),
        h_data[..., 7:20], mid(19, 20),
        h_data[..., 20:32], mid(31, 32),
        h_data[..., 32:45], mid(44, 45),
        h_data[..., 45:52]], axis=-1)


def feedback_from_ndp(ndp_chan: np.ndarray) -> np.ndarray:
    """STA side: effective channel rows for the BF report.

    ndp_chan: (nrx, nsts, 64) estimate exported by the RX for an NDP
    (includes per-stream CSD).  Returns (nrx, nsts, 56) over the occupied
    non-legacy tones with the CSD removed, pilot tones interpolated.
    """
    nrx, nsts, _ = ndp_chan.shape
    h = ndp_chan[:, :, T.DATA_IDX_NL].copy()
    # undo per-stream CSD so the AP sees the raw air channel
    for s in range(nsts):
        ramp = T.csd_phase(T.CSD_NL_NS[nsts - 1][s])[T.DATA_IDX_NL]
        h[:, s] = h[:, s] / ramp
    h56 = interp_pilot_tones(h)
    return h56


# ---------------------------------------------------------------------------
# Compressed beamforming report (Givens rotations, 21.3.12.3.6)
# ---------------------------------------------------------------------------

def _phi_grid(bits: int) -> np.ndarray:
    k = np.arange(2 ** bits)
    return k * np.pi / (2 ** (bits - 1)) + np.pi / (2 ** bits)


def _psi_grid(bits: int) -> np.ndarray:
    k = np.arange(2 ** bits)
    return k * np.pi / (2 ** (bits + 1)) + np.pi / (2 ** (bits + 2))


def givens_compress(v: np.ndarray, codebook: int = 0):
    """Decompose V (m x n, m >= n) into quantized (phi, psi) angle indices.

    Returns (values, types): types 0 = phi index, 1 = psi index, in the
    standard's angle ordering.  The V recovered by `givens_decompress`
    equals V' = V D~^H where D~ makes the last row real-positive (the
    beamformee-invariant form).
    """
    m, n = v.shape
    nb_phi, nb_psi = (9, 7) if codebook else (7, 5)
    phi_g, psi_g = _phi_grid(nb_phi), _psi_grid(nb_psi)
    # rotate columns so last row is real
    dt = np.exp(1j * np.angle(v[m - 1, :]))
    w = v * np.conj(dt)[None, :]
    w[m - 1, :] = w[m - 1, :].real
    values, types = [], []
    for i in range(1, min(m - 1, n) + 1):
        # column i-1: make all entries real via phase phis, then zero below
        # the diagonal with real Givens rotations
        phis = np.angle(w[i - 1: m - 1, i - 1])
        phis = np.unwrap(phis)
        if phis.size and phis[0] < 0:
            phis = phis + 2 * np.pi
        for p in phis:
            values.append(int(np.argmin(np.abs(phi_g - p))))
            types.append(0)
        d = np.ones(m, dtype=complex)
        d[i - 1: m - 1] = np.exp(1j * np.angle(w[i - 1: m - 1, i - 1]))
        w = np.conj(d)[:, None] * w
        w[i - 1: m, i - 1] = w[i - 1: m, i - 1].real
        for l in range(i + 1, m + 1):
            x1, x2 = w[i - 1, i - 1].real, w[l - 1, i - 1].real
            y = np.hypot(x1, x2)
            psi = np.arccos(np.clip(x1 / max(y, 1e-30), -1, 1))
            values.append(int(np.argmin(np.abs(psi_g - psi))))
            types.append(1)
            g = np.eye(m, dtype=complex)
            g[i - 1, i - 1] = np.cos(psi)
            g[i - 1, l - 1] = np.sin(psi)
            g[l - 1, i - 1] = -np.sin(psi)
            g[l - 1, l - 1] = np.cos(psi)
            w = g @ w
            w[l - 1, i - 1] = 0
    return values, types


def givens_decompress(values, types, m: int, n: int, codebook: int = 0) -> np.ndarray:
    """Reconstruct V~ (m x n) from quantized angles: V~ = prod Di Gli^T * I."""
    nb_phi, nb_psi = (9, 7) if codebook else (7, 5)
    phi_g, psi_g = _phi_grid(nb_phi), _psi_grid(nb_psi)
    vt = np.eye(m, dtype=complex)
    it = iter(zip(values, types))
    for i in range(1, min(m - 1, n) + 1):
        d = np.ones(m, dtype=complex)
        for j in range(i, m):
            val, ty = next(it)
            assert ty == 0
            d[j - 1] = np.exp(1j * phi_g[val])
        vt = vt @ np.diag(d)
        for l in range(i + 1, m + 1):
            val, ty = next(it)
            assert ty == 1
            psi = psi_g[val]
            g = np.eye(m, dtype=complex)
            g[i - 1, i - 1] = np.cos(psi)
            g[i - 1, l - 1] = np.sin(psi)
            g[l - 1, i - 1] = -np.sin(psi)
            g[l - 1, l - 1] = np.cos(psi)
            vt = vt @ g.T
    return vt[:, :n]


def pack_bf_report(values, types, codebook: int = 0) -> bytes:
    """Bit-pack the quantized angles (phi first ordering preserved)."""
    nb_phi, nb_psi = (9, 7) if codebook else (7, 5)
    bits = []
    for v, t in zip(values, types):
        nb = nb_phi if t == 0 else nb_psi
        bits += [(v >> i) & 1 for i in range(nb)]
    return T.bits_to_bytes(np.array(bits, dtype=np.uint8))


def unpack_bf_report(data: bytes, angle_types: list[int], codebook: int = 0):
    nb_phi, nb_psi = (9, 7) if codebook else (7, 5)
    bits = T.bytes_to_bits(data)
    values, pos = [], 0
    for t in angle_types:
        nb = nb_phi if t == 0 else nb_psi
        values.append(int(sum(int(bits[pos + i]) << i for i in range(nb))))
        pos += nb
    return values


def angle_order(m: int, n: int) -> list[int]:
    """Angle type sequence (0=phi, 1=psi) for an m x n V matrix."""
    types = []
    for i in range(1, min(m - 1, n) + 1):
        types += [0] * (m - i)
        types += [1] * (m - i)
    return types


# ---------------------------------------------------------------------------
# Zero-forcing spatial mapping
# ---------------------------------------------------------------------------

def zf_q(h_rows: np.ndarray) -> np.ndarray:
    """Per-subcarrier ZF precoder.

    h_rows: (n_sts_total, ntx, nsc) stacked per-user effective channel rows
    (user u's row(s) of the air channel).  Returns Q (nsc, ntx, n_sts) with
    H(k) Q(k) = c*I and Frobenius normalization ||Q(k)||_F = sqrt(nSTS).
    """
    nsts, ntx, nsc = h_rows.shape
    H = h_rows.transpose(2, 0, 1)                       # (nsc, nsts, ntx)
    Hh = np.conj(H.transpose(0, 2, 1))                  # (nsc, ntx, nsts)
    q = Hh @ np.linalg.inv(H @ Hh)                      # right inverse
    norm = np.linalg.norm(q, axis=(1, 2), keepdims=True)
    return q / norm * np.sqrt(nsts)


def q_to_grid(q56: np.ndarray) -> np.ndarray:
    """(56, ntx, nsts) occupied-tone Q -> (64, ntx, nsts) grid with identity
    on unused bins (DC/guards)."""
    nsc, ntx, nsts = q56.shape
    out = np.tile(np.eye(ntx, nsts, dtype=complex), (64, 1, 1))
    out[T.OCC_IDX_NL] = q56
    return out


# ---------------------------------------------------------------------------
# VHT compressed beamforming ACTION frame (9.6.22 / reference
# mac80211header.genMgmtActVhtCompressBf:624-671, mgmtVhtActCompressBfParser
# :688-730)
# ---------------------------------------------------------------------------

#: 20 MHz feedback subcarrier sets per grouping Ng (IEEE Table 9-79 subset
#: used by the reference, C_VHT_BFFB_SCIDX_20)
BFFB_SCIDX_20 = {
    1: [-28, -27, -26, -25, -24, -23, -22, -20, -19, -18, -17, -16, -15,
        -14, -13, -12, -11, -10, -9, -8, -6, -5, -4, -3, -2, -1,
        1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
        20, 22, 23, 24, 25, 26, 27, 28],
    2: [-28, -26, -24, -22, -20, -18, -16, -14, -12, -10, -8, -6, -4, -2,
        -1, 1, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28],
    4: [-28, -24, -20, -16, -12, -8, -4, -1, 1, 4, 8, 12, 16, 20, 24, 28],
}

#: map feedback tone index (-28..-1, 1..28) -> position in the 56-tone grid
_TONE_POS = {t: (t + 28 if t < 0 else t + 27) for t in range(-28, 29) if t}


def _snr_byte(snr_db: float) -> int:
    """Reference quantization: 0.25 dB steps over [-10, 53.75]."""
    k = int(round(np.clip((snr_db + 10.0) / 0.25, 0, 255)))
    return (k - 128) & 0xFF


def _snr_from_byte(b: int) -> float:
    signed = b - 256 if b >= 128 else b
    return (signed + 128) * 0.25 - 10.0


def mgmt_vht_bf_body(v56: np.ndarray, snr_db, group: int = 1,
                     codebook: int = 0, fb_type: int = 0,
                     token: int = 0) -> bytes:
    """VHT Compressed Beamforming action body (action value 0 + 3-byte VHT
    MIMO control + per-column SNR + packed Givens angles + MU-exclusive
    placeholder)."""
    v56 = np.asarray(v56)
    nsc, nr, nc = v56.shape
    assert nsc == 56 and group in BFFB_SCIDX_20
    gval = {1: 0, 2: 1, 4: 2}[group]
    ctrl = ((nc - 1) | ((nr - 1) << 3) | (0 << 6) | (gval << 8)
            | (codebook << 10) | (fb_type << 11) | (1 << 15) | (token << 18))
    body = b"\x00" + ctrl.to_bytes(4, "little")[:3]
    body += bytes(_snr_byte(s) for s in snr_db)
    nb_phi, nb_psi = (9, 7) if codebook else (7, 5)
    bits = []
    for t in BFFB_SCIDX_20[group]:
        values, types = givens_compress(v56[_TONE_POS[t]], codebook)
        for v, ty in zip(values, types):
            nb = nb_phi if ty == 0 else nb_psi
            bits += [(v >> i) & 1 for i in range(nb)]
    bits += [0] * (-len(bits) % 8)
    from ..spec import tables as T
    body += T.bits_to_bytes(np.array(bits, dtype=np.uint8))
    mu_ex_items = (30 if group == 1 else 10) * nc   # reference :660-668
    return body + b"\x00" * (mu_ex_items // 2)


def parse_mgmt_vht_bf(body: bytes):
    """Inverse of :func:`mgmt_vht_bf_body` -> dict with the control fields,
    per-column SNRs and the recovered (56, nr, nc) V (non-fed tones take
    the nearest fed tone, the reference's procVhtVIntpoV1 behavior)."""
    assert body[0] == 0
    ctrl = int.from_bytes(body[1:4], "little")
    nc = (ctrl & 7) + 1
    nr = ((ctrl >> 3) & 7) + 1
    group = 2 ** ((ctrl >> 8) & 3)
    codebook = (ctrl >> 10) & 1
    fb_type = (ctrl >> 11) & 1
    token = (ctrl >> 18) & 63
    snrs = [_snr_from_byte(b) for b in body[4: 4 + nc]]
    types = angle_order(nr, nc)
    nb_phi, nb_psi = (9, 7) if codebook else (7, 5)
    per_tone = sum(nb_phi if t == 0 else nb_psi for t in types)
    sc = BFFB_SCIDX_20[group]
    from ..spec import tables as T
    nbytes = -(-per_tone * len(sc) // 8)
    bits = T.bytes_to_bits(np.frombuffer(
        body[4 + nc: 4 + nc + nbytes], np.uint8))
    v_fed = {}
    pos = 0
    for t in sc:
        values = []
        for ty in types:
            nb = nb_phi if ty == 0 else nb_psi
            values.append(int(sum(int(bits[pos + i]) << i for i in range(nb))))
            pos += nb
        v_fed[t] = givens_decompress(values, types, nr, nc, codebook)
    v56 = np.zeros((56, nr, nc), complex)
    fed = np.array(sc)
    for t in range(-28, 29):
        if t == 0:
            continue
        src = fed[np.argmin(np.abs(fed - t))]
        v56[_TONE_POS[t]] = v_fed[int(src)]
    return {"nc": nc, "nr": nr, "group": group, "codebook": codebook,
            "fb_type": fb_type, "token": token, "snr_db": snrs, "v56": v56}
