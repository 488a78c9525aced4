"""Refractive-index database: .spd files and built-in tables.

Counterpart of `etx_tracer_tpu/scene/ior.py`, copied (numpy host code) so
that the port freezes the same spectra. Scans a directory tree for `.spd`
files (`#class:` header, `wavelength eta [k]` rows, wavelengths scaled x10
until >= 100 so um become nm) named by material; the search path is the
`folder` argument, else the ETX_SPECTRUM_PATH environment variable.

Without a .spd library, the Lorentz-Drude curves of `spectral_data.py`
serve gold, silver, copper and aluminium, and a compact built-in set other
conductors (coarse n/k tables) and dielectrics (Cauchy fits), and the
illuminant names resolve to the models of `spectral_data.py` (D65, the
CIE daylight curves, the white LEDs) or to Planck radiators.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.scene import spectral_data as sdata

_CLASS_MAP = {
    "conductor": sp.SpectralDistribution.CLASS_CONDUCTOR,
    "dielectric": sp.SpectralDistribution.CLASS_DIELECTRIC,
    "illuminant": sp.SpectralDistribution.CLASS_ILLUMINANT,
}


def parse_spd(text: str):
  """Parse .spd content -> (cls, title, wavelengths, v0, v1)."""
  cls = sp.SpectralDistribution.CLASS_INVALID
  title = ""
  wl, v0, v1 = [], [], []
  for line in text.splitlines():
    line = line.strip()
    if not line:
      continue
    if line.startswith("#"):
      if line.startswith("#class"):
        name = line.split(":", 1)[-1].strip().split()[0] if ":" in line else ""
        cls = _CLASS_MAP.get(name, sp.SpectralDistribution.CLASS_REFLECTANCE if name else cls)
      elif line.startswith("#title"):
        title = line.split(":", 1)[-1].strip()
      continue
    parts = line.split()
    if len(parts) >= 2:
      try:
        w = float(parts[0])
        a = float(parts[1])
        b = float(parts[2]) if len(parts) >= 3 else 0.0
      except ValueError:
        continue
      wl.append(w)
      v0.append(a)
      v1.append(b)
  if not wl:
    return cls, title, None, None, None
  wl = np.asarray(wl, np.float64)
  order = np.argsort(wl)
  wl = wl[order]
  v0 = np.asarray(v0, np.float64)[order]
  v1 = np.asarray(v1, np.float64)[order]
  # wavelength auto-scale (spectrum.cxx:256-261): um -> nm
  scale = 1.0
  mn = wl[0]
  while mn < 100.0:
    mn *= 10.0
    scale *= 10.0
  wl = wl * scale
  return cls, title, wl, v0, v1


def load_spd_file(path: str):
  """Returns (cls, eta SpectralDistribution, k SpectralDistribution)."""
  with open(path) as f:
    cls, title, wl, v0, v1 = parse_spd(f.read())
  if wl is None:
    return sp.SpectralDistribution.CLASS_INVALID, None, None
  keep = (wl >= sp.kShortestWavelength) & (wl <= sp.kLongestWavelength)
  if not keep.any():
    wl2 = np.array([sp.kShortestWavelength, sp.kLongestWavelength])
    v0 = np.full(2, v0[0]); v1 = np.full(2, v1[0]); wl = wl2
  else:
    wl, v0, v1 = wl[keep], v0[keep], v1[keep]
  # extend to full range holding end values (load path uses extend_range)
  if wl[0] > sp.kShortestWavelength:
    wl = np.concatenate([[sp.kShortestWavelength], wl])
    v0 = np.concatenate([[v0[0]], v0]); v1 = np.concatenate([[v1[0]], v1])
  if wl[-1] < sp.kLongestWavelength:
    wl = np.concatenate([wl, [sp.kLongestWavelength]])
    v0 = np.concatenate([v0, [v0[-1]]]); v1 = np.concatenate([v1, [v1[-1]]])
  eta = sp.SpectralDistribution.from_samples(wl, v0, cls)
  k = sp.SpectralDistribution.from_samples(wl, v1, cls)
  return cls, eta, k


# ---------------------------------------------------------------------------
# Built-in fallbacks (coarse approximations of standard published curves).
# wavelengths in nm; (eta, k) pairs.
# ---------------------------------------------------------------------------

_BUILTIN_CONDUCTORS = {
    # visible-range n/k, coarse 7-point approximations
    "gold": ([400, 450, 500, 550, 600, 650, 700],
             [1.66, 1.50, 0.85, 0.43, 0.25, 0.17, 0.16],
             [1.96, 1.88, 1.90, 2.46, 3.07, 3.15, 3.80]),
    "silver": ([400, 450, 500, 550, 600, 650, 700],
               [0.17, 0.15, 0.13, 0.12, 0.12, 0.14, 0.14],
               [1.95, 2.42, 2.92, 3.34, 3.73, 4.15, 4.52]),
    "copper": ([400, 450, 500, 550, 600, 650, 700],
               [1.17, 1.15, 1.12, 1.04, 0.54, 0.23, 0.21],
               [2.21, 2.40, 2.60, 2.59, 2.60, 3.21, 3.67]),
    "aluminium": ([400, 450, 500, 550, 600, 650, 700],
                  [0.49, 0.62, 0.77, 0.96, 1.20, 1.47, 1.83],
                  [4.86, 5.47, 6.08, 6.69, 7.26, 7.79, 8.31]),
    "mirror": ([400, 700], [0.12, 0.14], [3.0, 4.4]),
    # coarse visible-range n/k of other conductors, from standard published
    # optical data
    "nickel": ([400, 500, 600, 700],
               [1.61, 1.85, 2.02, 2.22], [2.36, 3.01, 3.57, 4.08]),
    "platinum": ([400, 500, 600, 700],
                 [1.72, 1.96, 2.18, 2.38], [2.84, 3.42, 3.95, 4.45]),
    "chrome": ([400, 500, 600, 700],
               [2.02, 2.50, 2.80, 3.04], [2.72, 3.13, 3.30, 3.33]),
    "titan": ([400, 500, 600, 700],
              [1.85, 2.11, 2.34, 2.54], [2.56, 2.88, 3.04, 3.16]),
    "osmium": ([400, 500, 600, 700],
               [2.36, 3.12, 3.82, 4.33], [3.02, 2.92, 2.28, 1.67]),
    "brass": ([400, 500, 600, 700],
              [1.22, 0.92, 0.44, 0.39], [1.76, 1.96, 2.72, 3.32]),
    "bronze": ([400, 500, 600, 700],
               [1.18, 1.08, 0.65, 0.40], [1.97, 2.21, 2.66, 3.28]),
    "carbon": ([400, 500, 600, 700],
               [2.42, 2.46, 2.47, 2.47], [0.79, 0.81, 0.81, 0.80]),
    "copper_oxide": ([400, 500, 600, 700],
                     [2.78, 2.69, 2.60, 2.54], [0.91, 0.62, 0.43, 0.33]),
}
_BUILTIN_CONDUCTORS["aluminum"] = _BUILTIN_CONDUCTORS["aluminium"]
for _alias, _name in (("au", "gold"), ("ag", "silver"), ("cu", "copper"),
                      ("al", "aluminium"), ("ni", "nickel"), ("pt", "platinum"),
                      ("cr", "chrome"), ("ti", "titan")):
  _BUILTIN_CONDUCTORS[_alias] = _BUILTIN_CONDUCTORS[_name]

_BUILTIN_DIELECTRICS = {
    # Cauchy n = A + B/lambda^2(um), fitted to published sodium-D / F / C
    # line indices (BK7 1.5168@587.6, water 1.3330@589.3, diamond
    # 2.417@589.3, sapphire 1.768@589.3).
    "glass": (1.5046, 0.00420),
    "glass-bk7": (1.5046, 0.00420),
    # fit through n=1.3330@589.3 and n=1.3373@486.1
    "water": (1.3238, 0.003182),
    "diamond": (2.3818, 0.0121),
    "sapphire": (1.7522, 0.00553),
    "vacuum": (1.0, 0.0),
    "air": (1.000277, 0.0),
    # through n=1.4730@589.3 with Abbe-number (~57) dispersion
    "glycerol": (1.4553, 0.00614),
    "plastic": (1.5750, 0.00527),
    "superglass": (1.8042, 0.01234),
}

# illuminant SPD names and their nominal CCTs
_BUILTIN_ILLUMINANT_CCT = {
    "blackbody_3000k": 3000.0, "blackbody_5000k": 5000.0,
    "blackbody_6500k": 6500.0, "daylight_5000k": 5000.0,
    "daylight_5500k": 5500.0, "daylight_6500k_noon_sky": 6500.0,
    "led_2700k_warm_white": 2700.0, "led_3000k_neutral_white": 3000.0,
    "led_4000k_cool_white": 4000.0, "led_5000k_daylight": 5000.0,
    "led_6500k_daylight": 6500.0, "led_high_cri_4000k": 4000.0,
    "tungsten_halogen_2856k": 2856.0,
}


class IORDatabase:
  def __init__(self, folder: Optional[str] = None):
    self.entries: dict[str, tuple] = {}
    folder = folder or os.environ.get("ETX_SPECTRUM_PATH", "")
    if folder and os.path.isdir(folder):
      self._scan(folder)

  def _scan(self, folder: str):
    for root, _, files in os.walk(folder):
      for fn in files:
        if fn.endswith(".spd"):
          path = os.path.join(root, fn)
          cls, eta, k = load_spd_file(path)
          if cls != sp.SpectralDistribution.CLASS_INVALID:
            key = os.path.splitext(fn)[0].lower()
            self.entries[key] = (cls, eta, k)

  def find(self, name: str):
    """Returns (cls, eta, k SpectralDistributions) or None."""
    key = os.path.splitext(os.path.basename(name))[0].lower()
    if key in self.entries:
      return self.entries[key]
    # Lorentz-Drude full-range curves (Rakic et al. 1998 parameters) for
    # the core conductors, preferred over the coarse tables
    ld_key = sdata.LD_ALIASES.get(key, key)
    if ld_key in sdata.LD_METALS:
      eta, k = sdata.conductor_spectra(ld_key)
      return sp.SpectralDistribution.CLASS_CONDUCTOR, eta, k
    if key == "d65":
      return sp.SpectralDistribution.CLASS_ILLUMINANT, sdata.d65(), None
    if key in _BUILTIN_CONDUCTORS:
      wl, n, kk = _BUILTIN_CONDUCTORS[key]
      cls = sp.SpectralDistribution.CLASS_CONDUCTOR
      eta = sp.SpectralDistribution.from_samples(
          np.array([sp.kShortestWavelength] + list(wl) + [sp.kLongestWavelength]),
          np.array([n[0]] + list(n) + [n[-1]]), cls)
      k = sp.SpectralDistribution.from_samples(
          np.array([sp.kShortestWavelength] + list(wl) + [sp.kLongestWavelength]),
          np.array([kk[0]] + list(kk) + [kk[-1]]), cls)
      return cls, eta, k
    if key in _BUILTIN_DIELECTRICS:
      a, b = _BUILTIN_DIELECTRICS[key]
      cls = sp.SpectralDistribution.CLASS_DIELECTRIC
      lam_um2 = (sp.GRID / 1000.0) ** 2
      eta = sp.SpectralDistribution((a + b / lam_um2).astype(np.float32), cls)
      k = sp.SpectralDistribution.constant(0.0, cls)
      return cls, eta, k
    if key in _BUILTIN_ILLUMINANT_CCT:
      cct = _BUILTIN_ILLUMINANT_CCT[key]
      if key.startswith("daylight"):
        spd = sdata.daylight(cct)
      elif key.startswith("led"):
        spd = sdata.led(cct, high_cri="high_cri" in key)
      else:
        # blackbody_* and the tungsten halogen are Planck radiators
        spd = sp.SpectralDistribution.from_normalized_black_body(cct, 1.0)
        spd.cls = sp.SpectralDistribution.CLASS_ILLUMINANT
      return sp.SpectralDistribution.CLASS_ILLUMINANT, spd, None
    return None
