"""Per-ray spectral response helpers.

Counterpart of `etx_tracer_tpu/render/spectral.py`. The mode is fixed per
render: responses are (R, C) tensors with C = 1 in spectral mode (one
wavelength per lane, carried beside the response) and C = 3 in RGB mode,
where a response is an RGB triple and film RGB is the response itself.
"""

from __future__ import annotations

import torch

from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.core import spectrum as sp


def channels(spectral: bool = False) -> int:
  return 1 if spectral else 3


def const(value, shape_like: torch.Tensor, spectral: bool = False) -> torch.Tensor:
  """Constant response broadcast over a wavefront; shape_like is (R, ...)."""
  return torch.full((shape_like.shape[0], channels(spectral)), value, dtype=torch.float32,
                    device=shape_like.device)


def query_spd(scene, spec_index: torch.Tensor, wl=None, spectral: bool = False) -> torch.Tensor:
  """Spectrum bank rows -> (R, C); a negative index yields zero.

  Spectral mode reads the bounce's bank at the lane wavelengths
  (`scene.spec_at_wl`) when `wl` is the very tensor it was evaluated at, and
  the bank itself otherwise."""
  safe = torch.clamp(spec_index, min=0)
  if spectral:
    cache = scene.spec_at_wl
    if cache is not None and cache[0] is wl and safe.dim() == 1:
      v = cache[1].gather(1, safe.to(torch.int64)[:, None])
    else:
      v = sp.query_bank(scene.spec_values, safe, wl)
  else:
    v = scene.spec_rgb[safe]
  return torch.where((spec_index >= 0)[..., None], v, 0.0)


def apply_rgb(response: torch.Tensor, rgb: torch.Tensor, wl=None,
              spectral: bool = False) -> torch.Tensor:
  """Scale a response by an RGB value; in spectral mode the RGB is upsampled
  through the basis at the lane's wavelength."""
  if spectral:
    return response * sp.rgb_response(wl, rgb)
  return response * rgb


def maximum(v: torch.Tensor) -> torch.Tensor:
  return torch.amax(v, dim=-1)


def is_zero(v: torch.Tensor) -> torch.Tensor:
  """Whether every channel of each response is at most kEpsilon."""
  return torch.amax(v, dim=-1) <= em.kEpsilon


def monochromatic(v: torch.Tensor, spectral: bool = False) -> torch.Tensor:
  """The scalar used for lobe selection: the value itself in spectral mode,
  the luminance in RGB mode."""
  if spectral:
    return v[..., 0]
  return em.luminance(v)


def to_film_rgb(v: torch.Tensor, wl=None, spectral: bool = False) -> torch.Tensor:
  """Accumulated response -> film RGB. Spectral: divide by the wavelength
  sampling pdf and project through the CIE curves to XYZ, then RGB."""
  if not spectral:
    return v
  scaled = v[..., 0] / sp.sampling_pdf(wl)
  return sp.xyz_to_rgb(sp.spectral_to_xyz(scaled, wl))
