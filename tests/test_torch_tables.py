"""The port's constant tables equal the JAX package's bit for bit.

The port carries no learned weights; its "parameters" are the constant
tables the receive chain is built from (DFT matrices, CRC and GF(2)
matrices, depuncture/interleave permutations, projectors, pilots and the
scrambler tables).  Each is rebuilt inside the port (it cannot import a
module that imports JAX) and must match the reference exactly.
"""
import numpy as np
import pytest
import torch

from gr_ieee80211_tpu.ops import cplx as JC
from gr_ieee80211_tpu.ops import crc as JCRC
from gr_ieee80211_tpu.ops import fastdecode as JFD
from gr_ieee80211_tpu.ops import ofdm as JOF
from gr_ieee80211_tpu.ops import viterbi as JV
from gr_ieee80211_tpu.ops import viterbi_pallas as JVP
from gr_ieee80211_tpu.spec.params import Fmt
from gr_ieee80211_tpu_torch.ops import cplx as PC
from gr_ieee80211_tpu_torch.ops import crc as PCRC
from gr_ieee80211_tpu_torch.ops import cuda_lib
from gr_ieee80211_tpu_torch.ops import fastdecode as PFD
from gr_ieee80211_tpu_torch.ops import ofdm as POF
from gr_ieee80211_tpu_torch.ops import viterbi as PV
from gr_ieee80211_tpu_torch.ops import viterbi_kernels as PVK
from gr_ieee80211_tpu_torch.spec.params import Fmt as PFmt

torch.set_num_threads(2)

RATES = ("1/2", "2/3", "3/4", "5/6")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_dft_matrices():
    for j, p in ((JC._dft64_mats(), PC._dft64_mats()),
                 (JC._idft64_mats(), PC._idft64_mats())):
        _same(j[0], p[0])
        _same(j[1], p[1])


@pytest.mark.parametrize("nbits", [64, 8 * 130, 8 * 530])
def test_crc_matrix(nbits):
    jm, jc = JCRC._crc_matrix(nbits)
    pm, pc = PCRC._crc_matrix(nbits)
    _same(jm, pm)
    _same(jc, pc)
    _same(JCRC.RESIDUE_BITS, PCRC.RESIDUE_BITS)


@pytest.mark.parametrize("cr", RATES)
def test_gf2_stencil(cr):
    _same(JFD._interior_matrix(cr), PFD._interior_matrix(cr))
    _same(JFD._keep_mask(cr, 2 * 733), PFD._keep_mask(cr, 2 * 733))
    _same(JFD._enc_matrix(3 * PFD.KB), PFD._enc_matrix(3 * PFD.KB))


@pytest.mark.parametrize("cr", RATES)
def test_depuncture_indices(cr):
    for n in (24, 733, 4420):
        ji, jn = JV.depuncture_indices(cr, n)
        pi, pn = PV.depuncture_indices(cr, n)
        _same(ji, pi)
        assert jn == pn


def test_delay_projector():
    for legacy in (False, True):
        for a, b in zip(JOF._delay_projector(legacy),
                        POF._delay_projector(legacy)):
            _same(a, b)


@pytest.mark.parametrize("fmt,nss,nsym", [(Fmt.L, 1, 26), (Fmt.HT, 1, 12),
                                          (Fmt.VHT, 1, 17), (Fmt.HT, 2, 9)])
def test_pilot_matrix(fmt, nss, nsym):
    _same(JOF._pilot_matrix(fmt, nss, nsym),
          POF._pilot_matrix(PFmt(fmt), nss, nsym))


@pytest.mark.parametrize("fmt,nbpscs,nss,nsym",
                         [(Fmt.L, 1, 1, 4), (Fmt.L, 4, 1, 6),
                          (Fmt.HT, 2, 1, 5), (Fmt.VHT, 6, 1, 17),
                          (Fmt.VHT, 8, 1, 3), (Fmt.HT, 4, 2, 3)])
def test_deint_deparse_perm(fmt, nbpscs, nss, nsym):
    _same(JOF._deint_deparse_perm(fmt, nbpscs, nss, nsym),
          POF._deint_deparse_perm(PFmt(fmt), nbpscs, nss, nsym))


def test_descramble_tables():
    for a, b in zip(JOF._descramble_tables(), POF._descramble_tables()):
        _same(a, b)
    for n in (7, 200, 4420):
        _same(JOF._descramble_matrix(n), POF._descramble_matrix(n))


def test_ltf_constants():
    for name in ("_LTF_L_REF", "_LTF_L_NZ", "_LTF_L_INV", "_LTF_NL_REF",
                 "_LTF_NL_NZ", "_LTF_NL_INV"):
        _same(getattr(JOF, name), getattr(POF, name))
    assert JOF._L_TO_NL_GAIN == POF._L_TO_NL_GAIN


def test_acs_branch_masks():
    """The port's (a00, a10) equal the Pallas kernel's iota-built masks,
    and the CUDA source's constants encode the same bits."""
    import re
    masks = JVP._branch_masks_in_kernel()
    a00, a10 = (np.asarray(m) for m in masks[(0, 0)])
    p00, p10 = PVK._branch_masks_np()
    _same(a00, p00)
    _same(a10, p10)
    src = (cuda_lib.CSRC / "viterbi.cu").read_text()
    assert re.search(r"p >> 4\) \^ \(p >> 3\) \^ \(p >> 1\) \^ p", src)
    assert re.search(r"p >> 5\) \^ \(p >> 4\) \^ \(p >> 3\) \^ p", src)


def test_segment_geometry_and_policy():
    for B_ in (5, 128, 256, 512, 2048, 4096):
        for T_ in (200, 1040, 4420, 16384, 32318):
            assert JVP._seg_geometry(B_, T_) == PVK._seg_geometry(B_, T_)
            assert JVP.segmented_pays(B_, T_) == PVK.segmented_pays(B_, T_)
    for name in ("T_CHUNK", "SEG_W", "SEG_TARGET_K", "PIN_LLR",
                 "NEG", "B_TILE"):
        assert getattr(JVP, name) == getattr(PVK, name), name
    for name in ("KB", "FALLBACK_B", "WIN_K", "WIN_W", "WIN_T", "WIN_MARGIN",
                 "PIN_LLR", "WIN_TIERS"):
        assert getattr(JFD, name) == getattr(PFD, name), name
