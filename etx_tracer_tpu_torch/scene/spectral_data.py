"""Lorentz-Drude conductors and the illuminant models.

Counterpart of `etx_tracer_tpu/scene/spectral_data.py`, copied so that the
port freezes the same spectrum bank: full-range n/k curves of gold, silver,
copper and aluminium from the Lorentz-Drude oscillator model with the
parameters published by Rakic, Djurisic, Elazar & Majewski, "Optical
properties of metallic films for vertical-cavity optoelectronic devices",
Applied Optics 37/22 (1998), Table 1, evaluated on the 1 nm grid
(`LD_METALS`, `LD_ALIASES`, `conductor_spectra`); and the illuminants: the
CIE D65 table (`d65`), the CIE D-series daylight eigenvector model
(`daylight`) and the Gaussian-phosphor white LED solved to a nominal CCT
(`led`).
"""

from __future__ import annotations

import os

import numpy as np

from etx_tracer_tpu_torch.core import spectrum as sp

# ---------------------------------------------------------------------------
# Lorentz-Drude model (Rakic et al. 1998, Table 1).
# epsilon(w) = 1 - f0 wp^2 / (w (w + i G0))
#             + sum_j f_j wp^2 / ((w_j^2 - w^2) - i w G_j)
# with photon energy w in eV. N = sqrt(eps), n = Re N, k = Im N.
# ---------------------------------------------------------------------------

# metal -> (wp_eV, [(f_j, Gamma_j_eV, omega_j_eV)]) ; j=0 is the Drude term
# (omega_0 = 0).
_LD_PARAMS = {
    "gold": (9.03, [
        (0.760, 0.053, 0.0),
        (0.024, 0.241, 0.415),
        (0.010, 0.345, 0.830),
        (0.071, 0.870, 2.969),
        (0.601, 2.494, 4.304),
        (4.384, 2.214, 13.32),
    ]),
    "silver": (9.01, [
        (0.845, 0.048, 0.0),
        (0.065, 3.886, 0.816),
        (0.124, 0.452, 4.481),
        (0.011, 0.065, 8.185),
        (0.840, 0.916, 9.083),
        (5.646, 2.419, 20.29),
    ]),
    "copper": (10.83, [
        (0.575, 0.030, 0.0),
        (0.061, 0.378, 0.291),
        (0.104, 1.056, 2.957),
        (0.723, 3.213, 5.300),
        (0.638, 4.305, 11.18),
    ]),
    "aluminium": (14.98, [
        (0.523, 0.047, 0.0),
        (0.227, 0.333, 0.162),
        (0.050, 0.312, 1.544),
        (0.166, 1.351, 1.808),
        (0.030, 3.382, 3.473),
    ]),
}

_EV_NM = 1239.84193  # photon energy (eV) * wavelength (nm)


def lorentz_drude_nk(metal: str, wavelengths_nm=None):
  """Complex IOR for `metal` on `wavelengths_nm` (default: engine grid).

  Returns (wavelengths, n, k) float64 arrays.
  """
  key = metal.lower()
  if key not in _LD_PARAMS:
    raise KeyError(f"no Lorentz-Drude parameters for {metal!r}")
  wp, osc = _LD_PARAMS[key]
  wl = np.asarray(wavelengths_nm if wavelengths_nm is not None else sp.GRID,
                  np.float64)
  w = _EV_NM / wl  # eV
  eps = np.ones_like(w, np.complex128)
  for (f, g, w0) in osc:
    if w0 == 0.0:
      eps -= f * wp * wp / (w * (w + 1j * g))
    else:
      eps += f * wp * wp / ((w0 * w0 - w * w) - 1j * w * g)
  n_c = np.sqrt(eps)
  # principal root with positive imaginary part (absorbing medium)
  n_c = np.where(n_c.imag < 0, -n_c, n_c)
  return wl, n_c.real.copy(), n_c.imag.copy()


def conductor_spectra(metal: str):
  """(eta, k) SpectralDistributions for a Lorentz-Drude metal."""
  wl, n, k = lorentz_drude_nk(metal)
  cls = sp.SpectralDistribution.CLASS_CONDUCTOR
  return (sp.SpectralDistribution.from_samples(wl, n, cls),
          sp.SpectralDistribution.from_samples(wl, k, cls))


LD_METALS = tuple(_LD_PARAMS)
LD_ALIASES = {"au": "gold", "ag": "silver", "cu": "copper",
              "al": "aluminium", "aluminum": "aluminium"}


# ---------------------------------------------------------------------------
# CIE standard illuminant D65: published relative SPD (CIE 15:2004 table,
# decimated to 20 nm), normalized to 100 at 560 nm.
# ---------------------------------------------------------------------------

_D65_WL = np.arange(380, 781, 20, dtype=np.float64)
_D65_V = np.array([
    49.98, 82.75, 93.43, 104.86, 117.01, 115.92, 109.35, 104.79, 104.41,
    100.00, 95.79, 90.01, 87.70, 83.70, 80.21, 78.27, 71.61, 61.60,
    75.09, 46.42, 63.38,
], np.float64)
assert _D65_WL.shape == _D65_V.shape


def d65() -> sp.SpectralDistribution:
  # hold the table ends so the engine grid (390-830) has no hard cliff
  wl = np.concatenate([[sp.kShortestWavelength - 1.0], _D65_WL,
                       [sp.kLongestWavelength + 1.0]])
  v = np.concatenate([[_D65_V[0]], _D65_V, [_D65_V[-1]]])
  return sp.SpectralDistribution.from_samples(
      wl, v / 100.0, sp.SpectralDistribution.CLASS_ILLUMINANT)


# ---------------------------------------------------------------------------
# CIE D-series daylight illuminants via the published eigenvector model
# (CIE 15:2004 section 3.1 / Judd, MacAdam & Wyszecki 1964):
#   S(lambda) = S0(lambda) + M1 S1(lambda) + M2 S2(lambda)
# with M1/M2 rational functions of the daylight chromaticity (xD, yD), and
# xD a published cubic in 1/T. The S components below are the standard CIE
# daylight eigenvectors at 10 nm (300-830). This gives REAL daylight curves
# for the reference's daylight_5000k/5500k/6500k illuminant names
# instead of blackbody stand-ins.
# ---------------------------------------------------------------------------

_S_WL = np.arange(300.0, 831.0, 10.0)
_S0 = np.array([
    0.04, 6.0, 29.6, 55.3, 57.3, 61.8, 61.5, 68.8, 63.4, 65.8,
    94.8, 104.8, 105.9, 96.8, 113.9, 125.6, 125.5, 121.3, 121.3, 113.5,
    113.1, 110.8, 106.5, 108.8, 105.3, 104.4, 100.0, 96.0, 95.1, 89.1,
    90.5, 90.3, 88.4, 84.0, 85.1, 81.9, 82.6, 84.9, 81.3, 71.9,
    74.3, 76.4, 63.3, 71.7, 77.0, 65.2, 47.7, 68.6, 65.0, 66.0,
    61.0, 53.3, 58.9, 61.9])
_S1 = np.array([
    0.02, 4.5, 22.4, 42.0, 40.6, 41.6, 38.0, 42.4, 38.5, 35.0,
    43.4, 46.3, 43.9, 37.1, 36.7, 35.9, 32.6, 27.9, 24.3, 20.1,
    16.2, 13.2, 8.6, 6.1, 4.2, 1.9, 0.0, -1.6, -3.5, -3.5,
    -5.8, -7.2, -8.6, -9.5, -10.9, -10.7, -12.0, -14.0, -13.6, -12.0,
    -13.3, -12.9, -10.6, -11.6, -12.2, -10.2, -7.8, -11.2, -10.4, -10.6,
    -9.7, -8.3, -9.3, -9.8])
_S2 = np.array([
    0.0, 2.0, 4.0, 8.5, 7.8, 6.7, 5.3, 6.1, 3.0, 1.2,
    -1.1, -0.5, -0.7, -1.2, -2.6, -2.9, -2.8, -2.6, -2.6, -1.8,
    -1.5, -1.3, -1.2, -1.0, -0.5, -0.3, 0.0, 0.2, 0.5, 2.1,
    3.2, 4.1, 4.7, 5.1, 6.7, 7.3, 8.6, 9.8, 10.2, 8.3,
    9.6, 8.5, 7.0, 7.6, 8.0, 6.7, 5.2, 7.4, 6.8, 7.0,
    6.4, 5.5, 6.1, 6.5])
assert _S_WL.shape == _S0.shape == _S1.shape == _S2.shape


def daylight_chromaticity(cct_kelvin: float):
  """Published daylight-locus chromaticity (xD, yD) for a nominal CCT.

  Applies the c2 radiation-constant correction (T = CCT * 1.4388/1.4380),
  the convention under which D65 corresponds to the nominal 6500 K.
  """
  t = float(cct_kelvin) * 1.4388 / 1.4380
  if not (4000.0 <= t <= 25000.0):
    raise ValueError(f"daylight CCT out of range: {cct_kelvin}")
  if t <= 7000.0:
    x = (-4.6070e9 / t**3 + 2.9678e6 / t**2 + 0.09911e3 / t + 0.244063)
  else:
    x = (-2.0064e9 / t**3 + 1.9018e6 / t**2 + 0.24748e3 / t + 0.237040)
  y = -3.000 * x * x + 2.870 * x - 0.275
  return x, y


def daylight_spd_values(cct_kelvin: float):
  """Relative daylight SPD on the 10 nm eigenvector grid (100 @ 560nm)."""
  x, y = daylight_chromaticity(cct_kelvin)
  denom = 0.0241 + 0.2562 * x - 0.7341 * y
  m1 = (-1.3515 - 1.7703 * x + 5.9114 * y) / denom
  m2 = (0.0300 - 31.4424 * x + 30.0717 * y) / denom
  s = _S0 + m1 * _S1 + m2 * _S2
  # normalize to 100 at 560nm (grid index of 560)
  i560 = int(np.where(_S_WL == 560.0)[0][0])
  return _S_WL.copy(), 100.0 * s / s[i560]


def daylight(cct_kelvin: float) -> sp.SpectralDistribution:
  """CIE D-series daylight illuminant as a SpectralDistribution."""
  wl, v = daylight_spd_values(cct_kelvin)
  return sp.SpectralDistribution.from_samples(
      wl, np.maximum(v, 0.0) / 100.0, sp.SpectralDistribution.CLASS_ILLUMINANT)


# ---------------------------------------------------------------------------
# White-LED emission via the standard Gaussian phosphor model (Ohno 2005,
# "Spectral design considerations for white LED color rendering", Opt. Eng.
# 44): a narrow blue InGaN pump plus broad phosphor Gaussians; the
# pump:phosphor ratio is solved numerically so the chromaticity lands on
# the target CCT (McCamy correlation). Derived, not measured — stands in
# for the reference's led_*.spd bins with the correct qualitative shape
# (blue peak + phosphor hump) and a validated CCT.
# ---------------------------------------------------------------------------


def _gauss(wl, mu, fwhm):
  s = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
  return np.exp(-0.5 * ((wl - mu) / s) ** 2)


def _xy_of(wl, v):
  xyz_bar = sp._xyz_bar_np(np.asarray(wl, np.float64))  # (N, 3)
  xyz = (xyz_bar * v[:, None]).sum(0)
  return xyz[0] / xyz.sum(), xyz[1] / xyz.sum()


def mccamy_cct(x, y):
  n = (x - 0.3320) / (0.1858 - y)
  return 449.0 * n**3 + 3525.0 * n**2 + 6823.3 * n + 5520.33


def led_spd_values(cct_kelvin: float, high_cri: bool = False):
  """White-LED relative SPD on a 1 nm grid (380-780), peak-normalized.

  Blue pump: 450 nm / 20 nm FWHM. Phosphor: YAG-like 560 nm / 110 nm FWHM
  plus a 630 nm / 90 nm red phosphor — warm-white bins physically require
  the red phosphor (a 560 nm phosphor alone saturates near 4300 K), and
  high-CRI bins carry extra red regardless of CCT (red-deficit repair,
  the standard recipe). CCT(c, rho) is not monotone in the phosphor
  fraction, so the (fraction, red-share) pair is chosen by a dense grid
  scan minimizing |McCamy CCT - nominal| with a Duv sanity bound, then
  the winner is kept.
  """
  wl = np.arange(380.0, 781.0, 1.0)
  blue = _gauss(wl, 450.0, 20.0)
  yellow = _gauss(wl, 560.0, 110.0)
  red = _gauss(wl, 630.0, 90.0)

  rho_grid = np.linspace(0.6, 2.5, 20) if high_cri \
      else np.linspace(0.0, 2.5, 26)
  c_grid = np.exp(np.linspace(np.log(0.1), np.log(60.0), 120))

  best = None
  for rho in rho_grid:
    ph = yellow + rho * red
    for c in c_grid:
      v = blue + c * ph
      x, y = _xy_of(wl, v)
      # keep near the Planckian locus (Judd-line sanity via y range)
      if not (0.25 <= y <= 0.45 and 0.25 <= x <= 0.55):
        continue
      err = abs(mccamy_cct(x, y) - cct_kelvin)
      if best is None or err < best[0]:
        best = (err, c, rho)
  assert best is not None, "LED solver found no on-locus mixture"
  _, c, rho = best
  v = blue + c * (yellow + rho * red)
  return wl, v / v.max()


def led(cct_kelvin: float, high_cri: bool = False) -> sp.SpectralDistribution:
  wl, v = led_spd_values(cct_kelvin, high_cri)
  return sp.SpectralDistribution.from_samples(
      wl, v, sp.SpectralDistribution.CLASS_ILLUMINANT)


def write_spd_library(folder: str):
  """Write the derived conductor and illuminant library as `.spd` files
  that `scene/ior.py`'s scanner reads (the reference's on-disk format: a
  `#class:` header, then `wavelength eta k` rows): `conductor/<metal>.spd`
  for every Lorentz-Drude metal and `emission/d65.spd`. Returns the paths."""
  cdir = os.path.join(folder, "conductor")
  edir = os.path.join(folder, "emission")
  os.makedirs(cdir, exist_ok=True)
  os.makedirs(edir, exist_ok=True)
  written = []
  for metal in LD_METALS:
    wl, n, k = lorentz_drude_nk(metal, np.arange(360.0, 831.0, 5.0))
    path = os.path.join(cdir, f"{metal}.spd")
    with open(path, "w") as f:
      f.write(f"#class: conductor\n#title: {metal} (Lorentz-Drude, "
              "Rakic et al. 1998)\n")
      for i in range(wl.shape[0]):
        f.write(f"{wl[i]:.1f} {n[i]:.6f} {k[i]:.6f}\n")
    written.append(path)
  path = os.path.join(edir, "d65.spd")
  with open(path, "w") as f:
    f.write("#class: illuminant\n#title: CIE standard illuminant D65\n")
    for i in range(_D65_WL.shape[0]):
      f.write(f"{_D65_WL[i]:.1f} {_D65_V[i]:.2f}\n")
  written.append(path)
  return written
