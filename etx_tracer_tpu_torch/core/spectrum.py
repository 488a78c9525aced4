"""Spectral distributions, wavelength sampling and CIE conversion.

Counterpart of `etx_tracer_tpu/core/spectrum.py`:

- host-side SPDs on the dense 1 nm grid 390..830 nm, their CIE XYZ
  integral and the integrated RGB; together they fill the scene's spectrum
  bank (`spec_values`, `spec_rgb`). An SPD made from an RGB triple keeps
  that triple as its integrated RGB; its grid values come from the same
  derived RGB upsampling basis as in the JAX package;
- spectral mode on the device: the sech^2 wavelength sampler and its pdf,
  the CIE colour matching functions, the blackbody curve, the RGB basis at
  a wavelength, and queries of the bank at each lane's wavelength. The JAX
  package evaluates the whole bank at a wavelength as a HIGHEST-precision
  one-hot matmul; here it is the two-tap lerp gather that matmul computes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

kShortestWavelength = 390.0
kLongestWavelength = 830.0
kWavelengthCount = 441


def _xyz_bar_np(wl):
  """CIE 1931 2-degree colour matching functions (Wyman, Sloan & Shirley fits)."""
  def g(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    t = (x - mu) * s
    return alpha * np.exp(-0.5 * t * t)

  x = g(wl, 0.362, 442.0, 0.0624, 0.0374) + g(wl, 1.056, 599.8, 0.0264, 0.0323) + g(wl, -0.065, 501.1, 0.0490, 0.0382)
  y = g(wl, 0.821, 568.8, 0.0213, 0.0247) + g(wl, 0.286, 530.9, 0.0613, 0.0322)
  z = g(wl, 1.217, 437.0, 0.0845, 0.0278) + g(wl, 0.681, 459.0, 0.0385, 0.0725)
  return np.stack([x, y, z], axis=-1)


GRID = np.arange(kWavelengthCount, dtype=np.float64) + kShortestWavelength
_XYZ_GRID = _xyz_bar_np(GRID)
Y_INTEGRAL = float(_XYZ_GRID[:, 1].sum())

# sRGB D65
XYZ_TO_RGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
], dtype=np.float32)

RGB_TO_XYZ = np.array([
    [0.4124564, 0.3575760, 0.1804375],
    [0.2126729, 0.7151521, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041],
], dtype=np.float32)


def _piecewise_gauss(x, alpha, mu, s1, s2):
  s = torch.where(x < mu, s1, s2)
  t = (x - mu) * s
  return alpha * torch.exp(-0.5 * t * t)


def xyz_bar(wl: torch.Tensor) -> torch.Tensor:
  """CIE 1931 2-degree colour matching functions at wavelength(s) wl [nm]."""
  x = (_piecewise_gauss(wl, 0.362, 442.0, 0.0624, 0.0374)
       + _piecewise_gauss(wl, 1.056, 599.8, 0.0264, 0.0323)
       + _piecewise_gauss(wl, -0.065, 501.1, 0.0490, 0.0382))
  y = (_piecewise_gauss(wl, 0.821, 568.8, 0.0213, 0.0247)
       + _piecewise_gauss(wl, 0.286, 530.9, 0.0613, 0.0322))
  z = (_piecewise_gauss(wl, 1.217, 437.0, 0.0845, 0.0278)
       + _piecewise_gauss(wl, 0.681, 459.0, 0.0385, 0.0725))
  return torch.stack([x, y, z], dim=-1)


def _mat3(m: np.ndarray, v: torch.Tensor) -> torch.Tensor:
  """m @ v over the trailing axis, summed term by term in float32."""
  c = m.tolist()
  rows = [c[i][0] * v[..., 0] + c[i][1] * v[..., 1] + c[i][2] * v[..., 2] for i in range(3)]
  return torch.stack(rows, dim=-1)


def xyz_to_rgb(xyz: torch.Tensor) -> torch.Tensor:
  return _mat3(XYZ_TO_RGB, xyz)


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
  return _mat3(RGB_TO_XYZ, rgb)


# Wavelength importance sampling: the sech^2 map truncated to [390, 830].
_SAMPLE_OFFSET = float.fromhex("0x1.35ce7a0000000p-5")
_SAMPLE_SCALE = 1.0 - _SAMPLE_OFFSET


def sample_wavelength(rnd: torch.Tensor) -> torch.Tensor:
  """Importance-sample a wavelength with the sech^2-shaped pdf."""
  x = rnd * _SAMPLE_SCALE + _SAMPLE_OFFSET
  return 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * x)


def sampling_pdf(wl: torch.Tensor) -> torch.Tensor:
  """pdf of sample_wavelength (the untruncated map's density, as the JAX
  package and its reference keep it)."""
  c = torch.cosh(0.0072 * (wl - 538.0))
  return 0.0039398042 / (c * c)


def spectral_to_xyz(value: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
  """Single-wavelength response -> XYZ; zero outside the sampled range."""
  in_range = (wl >= kShortestWavelength) & (wl <= kLongestWavelength)
  xyz = xyz_bar(wl) * (value / Y_INTEGRAL)[..., None]
  return torch.where(in_range[..., None], xyz, 0.0)


def black_body_radiation_maximum_wavelength(t_kelvins):
  """Wien's displacement law: the peak wavelength (nm) at t_kelvins."""
  return 2.8977729e6 / t_kelvins


def black_body_radiation(wavelength_nm: torch.Tensor, t_kelvins) -> torch.Tensor:
  """Planck's law at wavelength(s) wavelength_nm, as the reference scales it."""
  scale = 1.0 / 1000.0
  lc1 = 3.7417712e5
  lc2 = 1.4387752e4
  w = wavelength_nm * scale
  wl5 = w * (w * w) * (w * w)
  e0 = torch.exp(lc2 / (w * t_kelvins))
  d = wl5 * (e0 - 1.0)
  return torch.where(torch.isinf(d) | (d <= 0.0), 0.0, lc1 / torch.clamp(d, min=1e-30))


def _black_body_np(wavelength_nm, t_kelvins):
  scale = 1.0 / 1000.0
  lc1 = 3.7417712e5
  lc2 = 1.4387752e4
  w = wavelength_nm * scale
  wl5 = w * (w * w) * (w * w)
  with np.errstate(over="ignore"):
    e0 = np.exp(lc2 / (w * t_kelvins))
  d = wl5 * (e0 - 1.0)
  return np.where(np.isinf(d) | (d <= 0.0), 0.0, lc1 / np.maximum(d, 1e-30))


@functools.lru_cache(maxsize=1)
def _rgb_basis_np() -> np.ndarray:
  """Three smooth non-negative spectra B_r, B_g, B_b on the grid such that
  integrating c.B against the CIE curves recovers (about) the XYZ of c.

  Regularized least squares with a non-negativity projection, solved once.
  """
  n = kWavelengthCount
  m = (_XYZ_GRID / Y_INTEGRAL).T  # (3, N): maps spectrum -> XYZ
  t = RGB_TO_XYZ.astype(np.float64)  # t[:, i] = xyz of primary i
  d2 = np.zeros((n - 2, n))
  for i in range(n - 2):
    d2[i, i] = 1.0
    d2[i, i + 1] = -2.0
    d2[i, i + 2] = 1.0
  alpha = 2e-5
  a = m.T @ m + alpha * (d2.T @ d2) + 1e-9 * np.eye(n)
  basis = np.linalg.solve(a, m.T @ t)  # (N, 3)
  for _ in range(8):
    basis = np.maximum(basis, 0.0)
    cur = m @ basis
    scale, *_ = np.linalg.lstsq(cur, t, rcond=None)
    basis = basis @ scale
  basis = np.maximum(basis, 0.0)
  return basis.astype(np.float32)


@functools.lru_cache(maxsize=None)
def rgb_basis(device=None) -> torch.Tensor:
  """The (441, 3) RGB upsampling basis as a tensor, made once per device."""
  return torch.from_numpy(_rgb_basis_np()).to(device)


def _grid_lerp(wl: torch.Tensor):
  """Grid index of each wavelength and its lerp weight."""
  idx_f = torch.clamp(wl - kShortestWavelength, 0.0, kWavelengthCount - 1.000001)
  i0 = idx_f.to(torch.int64)
  return i0, idx_f - i0.to(torch.float32)


def rgb_response(wl: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
  """The RGB-upsampled reflectance c.B(wl): shape rgb[..., :1]."""
  basis = rgb_basis(wl.device)
  i0, frac = _grid_lerp(wl)
  b0 = basis[i0]
  b1 = basis[torch.clamp(i0 + 1, max=kWavelengthCount - 1)]
  b = b0 * (1.0 - frac[..., None]) + b1 * frac[..., None]
  return (b * rgb).sum(dim=-1, keepdim=True)


def bank_at_wl(bank_values: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
  """Every SPD of the (S, 441) bank at each lane's wavelength: (R, S)."""
  i0, frac = _grid_lerp(wl)
  v0 = bank_values[:, i0].T
  v1 = bank_values[:, torch.clamp(i0 + 1, max=kWavelengthCount - 1)].T
  return v0 * (1.0 - frac[:, None]) + v1 * frac[:, None]


def query_bank(bank_values: torch.Tensor, index: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
  """SPD `index` of the (S, 441) bank at wavelength(s) wl: shape wl[..., None]."""
  i0, frac = _grid_lerp(wl)
  v0 = bank_values[index, i0]
  v1 = bank_values[index, torch.clamp(i0 + 1, max=kWavelengthCount - 1)]
  return (v0 * (1.0 - frac) + v1 * frac)[..., None]


class SpectralDistribution:
  """Host-side SPD on the dense 1 nm grid plus its integrated RGB value."""

  CLASS_INVALID = 0
  CLASS_REFLECTANCE = 1
  CLASS_CONDUCTOR = 2
  CLASS_DIELECTRIC = 3
  CLASS_ILLUMINANT = 4

  def __init__(self, grid_values, cls: int = CLASS_REFLECTANCE, integrated=None):
    grid_values = np.asarray(grid_values)
    if grid_values.shape != (kWavelengthCount,):
      raise ValueError(f"grid values must have shape ({kWavelengthCount},)")
    self.values = grid_values.astype(np.float32)
    self.cls = cls
    self._integrated = None if integrated is None else np.asarray(integrated, np.float32)

  @staticmethod
  def null() -> "SpectralDistribution":
    return SpectralDistribution(np.zeros(kWavelengthCount), SpectralDistribution.CLASS_INVALID)

  @staticmethod
  def constant(value: float, cls: int = CLASS_REFLECTANCE) -> "SpectralDistribution":
    return SpectralDistribution(np.full(kWavelengthCount, value), cls)

  @staticmethod
  def from_samples(wavelengths, powers, cls: int = CLASS_REFLECTANCE) -> "SpectralDistribution":
    """Piecewise-linear resample onto the dense grid, zero outside the
    sampled range."""
    wavelengths = np.asarray(wavelengths, dtype=np.float64)
    powers = np.asarray(powers, dtype=np.float64)
    order = np.argsort(wavelengths)
    wavelengths, powers = wavelengths[order], powers[order]
    vals = np.interp(GRID, wavelengths, powers, left=0.0, right=0.0)
    vals[GRID < wavelengths[0]] = 0.0
    vals[GRID > wavelengths[-1]] = 0.0
    return SpectralDistribution(vals, cls)

  @staticmethod
  def from_black_body(temperature: float, scale: float = 1.0) -> "SpectralDistribution":
    vals = _black_body_np(GRID, temperature) * scale
    return SpectralDistribution(vals, SpectralDistribution.CLASS_ILLUMINANT)

  @staticmethod
  def from_normalized_black_body(temperature: float, scale: float = 1.0) -> "SpectralDistribution":
    """Blackbody normalized to unit luminance, then scaled."""
    sd = SpectralDistribution.from_black_body(temperature, 1.0)
    lum = sd.luminance()
    if lum > 0:
      sd.values *= scale / lum
    return sd

  @staticmethod
  def rgb_reflectance(rgb) -> "SpectralDistribution":
    rgb = np.asarray(rgb, dtype=np.float32)
    return SpectralDistribution(_rgb_basis_np() @ rgb,
                                SpectralDistribution.CLASS_REFLECTANCE, integrated=rgb)

  @staticmethod
  def rgb_luminance(rgb) -> "SpectralDistribution":
    rgb = np.asarray(rgb, dtype=np.float32)
    return SpectralDistribution(_rgb_basis_np() @ rgb,
                                SpectralDistribution.CLASS_ILLUMINANT, integrated=rgb)

  def integrate_to_xyz(self) -> np.ndarray:
    return (_XYZ_GRID * self.values[:, None]).sum(axis=0) / Y_INTEGRAL

  def integrated_rgb(self) -> np.ndarray:
    """RGB value used in RGB-mode rendering: one row of the spectrum bank."""
    if self._integrated is not None:
      return self._integrated
    xyz = self.integrate_to_xyz()
    return XYZ_TO_RGB @ xyz.astype(np.float32)

  def luminance(self) -> float:
    return float(self.integrate_to_xyz()[1])

  def maximum_power(self) -> float:
    return float(self.values.max())

  def scale(self, factor: float) -> "SpectralDistribution":
    """Scale in place (the grid values and the integrated RGB)."""
    self.values *= factor
    if self._integrated is not None:
      self._integrated = self._integrated * factor
    return self
