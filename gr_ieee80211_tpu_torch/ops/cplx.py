"""Complex arithmetic as (re, im) float32 tensor pairs.

Port of ``gr_ieee80211_tpu.ops.cplx``.  The port keeps the reference's
:class:`CF` pair layout rather than ``torch.complex64`` so that every
sum is taken in the same order as the JAX package and the tests compare
like with like.  The 64-point (I)DFT is four real 64x64 matmuls on the
fftshifted grid of ``_dft64_mats``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import trace


class CF(NamedTuple):
    """Complex tensor as a (re, im) pair of real tensors."""
    re: torch.Tensor
    im: torch.Tensor

    # -- structure ---------------------------------------------------------
    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def device(self):
        return self.re.device

    def __getitem__(self, idx):
        return CF(self.re[idx], self.im[idx])

    def reshape(self, *s):
        return CF(self.re.reshape(*s), self.im.reshape(*s))

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, CF):
            return CF(self.re + o.re, self.im + o.im)
        return CF(self.re + o, self.im)

    def __sub__(self, o):
        if isinstance(o, CF):
            return CF(self.re - o.re, self.im - o.im)
        return CF(self.re - o, self.im)

    def __mul__(self, o):
        if isinstance(o, CF):
            return CF(self.re * o.re - self.im * o.im,
                      self.re * o.im + self.im * o.re)
        return CF(self.re * o, self.im * o)  # real scalar/tensor

    __rmul__ = __mul__

    def conj(self):
        return CF(self.re, -self.im)

    def mul_conj(self, o: "CF") -> "CF":
        """self * conj(o)."""
        return CF(self.re * o.re + self.im * o.im,
                  self.im * o.re - self.re * o.im)

    def abs2(self) -> torch.Tensor:
        return self.re * self.re + self.im * self.im

    def abs(self) -> torch.Tensor:
        return torch.sqrt(self.abs2())

    def angle(self) -> torch.Tensor:
        return torch.atan2(self.im, self.re)

    def __truediv__(self, o):
        if isinstance(o, CF):
            d = o.abs2()
            d = torch.where(d > 1e-24, d, torch.full_like(d, 1e-24))
            return CF((self.re * o.re + self.im * o.im) / d,
                      (self.im * o.re - self.re * o.im) / d)
        return CF(self.re / o, self.im / o)

    def unit(self) -> "CF":
        """self / |self| (safe)."""
        a = torch.clamp(self.abs(), min=1e-12)
        return CF(self.re / a, self.im / a)


def from_numpy_cf(x: np.ndarray, device) -> CF:
    """Host complex ndarray -> CF of float32 tensors on ``device``
    (counterpart of the reference's ``from_host``)."""
    x = np.asarray(x)
    return CF(torch.from_numpy(np.ascontiguousarray(x.real, np.float32)).to(device),
              torch.from_numpy(np.ascontiguousarray(x.imag, np.float32)).to(device))


def from_numpy_cf_bf16(x: np.ndarray, device) -> CF:
    """Host complex ndarray -> CF staged as bfloat16 on ``device`` (half
    the upload bytes; ~49 dB SQNR).  Counterpart of ``from_host_bf16``:
    the float32 -> bfloat16 rounding is round-to-nearest-even in both."""
    c = from_numpy_cf(x, device)
    return CF(c.re.to(torch.bfloat16), c.im.to(torch.bfloat16))


def from_numpy_cf_i8(x: np.ndarray, device) -> CF:
    """Host complex ndarray -> CF through int8 (a quarter of the float32
    upload bytes; ~48 dB SQNR at full scale).  Counterpart of
    ``from_host_i8``: one shared block-AGC scale per call quantizes re/im
    to [-127, 127] on the host, and one multiply by the float32 inverse
    scale dequantizes on ``device``."""
    x = np.asarray(x)
    m = float(max(np.abs(x.real).max(initial=0.0),
                  np.abs(x.imag).max(initial=0.0), 1e-9))
    s = 127.0 / m
    inv = torch.tensor(np.float32(m / 127.0), device=device)

    def one(a):
        q = np.clip(np.rint(a * s), -127, 127).astype(np.int8)
        return torch.from_numpy(q).to(device).to(torch.float32) * inv
    return CF(one(x.real), one(x.imag))


def cf_from_pair(re: np.ndarray, im: np.ndarray, device) -> CF:
    """A reference ``CF`` pulled to numpy (``np.asarray(cf.re)``, ...) ->
    the port's CF on ``device``.  Keeps the dtype (float32, or bfloat16
    via float32)."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return CF(one(re), one(im))


def to_numpy(cf: CF) -> np.ndarray:
    return (cf.re.float().cpu().numpy()
            + 1j * cf.im.float().cpu().numpy())


def expj(theta: torch.Tensor) -> CF:
    """exp(j*theta)."""
    return CF(torch.cos(theta), torch.sin(theta))


def csum(cf: CF, dim) -> CF:
    return CF(cf.re.sum(dim=dim), cf.im.sum(dim=dim))


def cstack(cfs: list[CF], dim: int = 0) -> CF:
    return CF(torch.stack([c.re for c in cfs], dim=dim),
              torch.stack([c.im for c in cfs], dim=dim))


# ---------------------------------------------------------------------------
# 64-point DFT / IDFT (fftshifted grid convention)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dft64_mats():
    """Real/imag DFT matrices mapping 64 time samples -> fftshifted grid.

    grid[i] = sum_n x[n] * exp(-2j*pi*n*(i-32)/64)  (fftshift built in).
    """
    n = np.arange(64)[:, None]
    k = (np.arange(64) - 32)[None, :]
    ang = -2 * np.pi * n * k / 64.0
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _idft64_mats():
    """Fftshifted grid -> 64 time samples (numpy ifft normalization 1/64)."""
    k = (np.arange(64) - 32)[:, None]
    n = np.arange(64)[None, :]
    ang = 2 * np.pi * k * n / 64.0
    return ((np.cos(ang) / 64).astype(np.float32),
            (np.sin(ang) / 64).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _mats_on(which: str, device: torch.device):
    """The float32 DFT matrices, widened to float64, cached per device."""
    C, S = _dft64_mats() if which == "dft" else _idft64_mats()
    with trace.sync("table_upload", 2):
        return (torch.from_numpy(C).to(device, torch.float64),
                torch.from_numpy(S).to(device, torch.float64))


def _cmatmul(x: CF, which: str) -> CF:
    # The float32 matrices are applied in float64 and the result rounded to
    # float32: a lower-precision pass (TF32 on the card) flips QAM
    # decisions near boundaries and loses frames at MCS7, and a float64
    # product cannot take the TF32 path whatever
    # torch.backends.cuda.matmul.allow_tf32 says.
    C, S = _mats_on(which, x.re.device)
    xr = x.re.to(torch.float64)
    xi = x.im.to(torch.float64)
    re = xr @ C - xi @ S
    im = xr @ S + xi @ C
    return CF(re.to(torch.float32), im.to(torch.float32))


def dft64(x: CF) -> CF:
    """(..., 64) time windows -> fftshifted grids."""
    return _cmatmul(x, "dft")


def idft64(g: CF) -> CF:
    """(..., 64) fftshifted grids -> time samples (1/64 normalized)."""
    return _cmatmul(g, "idft")
