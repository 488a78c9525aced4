"""Lorentz-Drude complex refractive indices of the core conductors.

Counterpart of the conductor part of `etx_tracer_tpu/scene/spectral_data.py`
(`LD_METALS`, `LD_ALIASES`, `conductor_spectra`), copied so that the port
freezes the same spectrum bank: full-range n/k curves of gold, silver,
copper and aluminium from the Lorentz-Drude oscillator model with the
parameters published by Rakic, Djurisic, Elazar & Majewski, "Optical
properties of metallic films for vertical-cavity optoelectronic devices",
Applied Optics 37/22 (1998), Table 1, evaluated on the 1 nm grid. The
illuminant models of that module (D65, daylight, LEDs) belong to the slice
that brings environment and atmosphere scenes.
"""

from __future__ import annotations

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
