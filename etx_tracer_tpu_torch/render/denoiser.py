"""Feature-guided denoiser (the OIDN role of the reference,
render/host/denoiser.cxx).

Counterpart of `etx_tracer_tpu/render/denoiser.py`: an edge-avoiding
a-trous wavelet filter (Dammertz et al.) guided by the film's normal and
albedo layers, with an SVGF-style noise-normalised luminance weight when a
variance estimate is given, and a firefly pre-filter. Plain PyTorch on the
film's device. Neighbours are read through `torch.roll`, so the filters
wrap around the image edges (toroidally), as the JAX package's `jnp.roll`
does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from etx_tracer_tpu_torch.render import film as film_mod

_KERNEL = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
_LUM_W = (0.212671, 0.715160, 0.072169)


def _lum(x: torch.Tensor) -> torch.Tensor:
  return torch.sum(x * torch.tensor(_LUM_W, device=x.device), dim=-1)


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
  return torch.roll(img, (dy, dx), dims=(0, 1))


def _box3(x: torch.Tensor) -> torch.Tensor:
  acc = torch.zeros_like(x)
  for dy in (-1, 0, 1):
    for dx in (-1, 0, 1):
      acc = acc + _shift2d(x, dy, dx)
  return acc / 9.0


def denoise(color, normals, albedo, variance=None, iterations: int = 3,
            sigma_color: float = 0.25, sigma_normal: float = 0.3,
            sigma_albedo: float = 0.15, sigma_l: float = 4.0) -> torch.Tensor:
  """Denoise (H,W,3) color using the normal and albedo guides.

  variance: optional (H,W) per-pixel luminance variance estimate (the
  film's two-buffer noise estimate). When given, the colour weight is
  |dl| / (sigma_l * sqrt(var)) over a 3x3-smoothed variance, so smooth
  noisy regions filter hard while real edges survive; without it a
  relative-luminance distance is used."""
  out = color
  var = variance
  for it in range(iterations):
    step = 1 << it
    acc = torch.zeros_like(out)
    wsum = torch.zeros(out.shape[:2], device=out.device)
    center_l = _lum(out)
    if var is not None:
      noise = torch.sqrt(torch.clamp(_box3(var), min=0.0)) + 1e-4
    for ky in range(5):
      for kx in range(5):
        dy = (ky - 2) * step
        dx = (kx - 2) * step
        w_k = float(_KERNEL[ky] * _KERNEL[kx])
        c = _shift2d(out, dy, dx)
        n = _shift2d(normals, dy, dx)
        a = _shift2d(albedo, dy, dx)
        if var is not None:
          d_l = torch.abs(_lum(c) - center_l) / (sigma_l * noise)
          w_c = torch.exp(-d_l)
        else:
          d_r = (_lum(c) - center_l) / (torch.abs(center_l) + 0.2)
          w_c = torch.exp(-(d_r * d_r) / (2.0 * sigma_color * sigma_color))
        d_n = torch.sum((n - normals) ** 2, dim=-1)
        w_n = torch.exp(-d_n / (2.0 * sigma_normal * sigma_normal))
        d_a = torch.sum((a - albedo) ** 2, dim=-1)
        w_a = torch.exp(-d_a / (2.0 * sigma_albedo * sigma_albedo))
        wgt = w_k * w_c * w_n * w_a
        acc = acc + c * wgt[..., None]
        wsum = wsum + wgt
    out = acc / torch.clamp(wsum, min=1e-8)[..., None]
    if var is not None:
      # filtering shrinks the residual variance roughly by the effective
      # sample count; the kernel-squared factor stands in for it
      var = _box3(var) * 0.25
  return out


def firefly_clamp(color: torch.Tensor, k: float = 4.0) -> torch.Tensor:
  """A pixel whose luminance exceeds k x its 8-neighbourhood mean (plus
  1e-3) is replaced by that mean. The neighbourhood wraps around the image
  edges."""
  nb = (9.0 * _box3(color) - color) / 8.0
  nb_lum = torch.clamp(_lum(nb), min=0.0)
  hot = _lum(color) > k * nb_lum + 1e-3
  return torch.where(hot[..., None], nb, color)


def film_variance(film_state: film_mod.FilmState) -> torch.Tensor:
  """Per-pixel luminance variance estimate from the film's two buffers."""
  return (_lum(film_state.camera) - _lum(film_state.variance_half)) ** 2


def denoise_film(film_state: film_mod.FilmState, iterations: int | None = None) -> torch.Tensor:
  """Denoise the film's result with its normal and albedo layers and its
  variance estimate, after the firefly pre-filter. iterations defaults by
  film size: 2 a-trous levels up to 63 pixels a side, 5 from 256."""
  if iterations is None:
    side = min(film_state.camera.shape[0], film_state.camera.shape[1])
    iterations = max(2, min(5, int(math.log2(max(side, 4))) - 3))
  color = firefly_clamp(film_mod.result_image(film_state))
  return denoise(color, film_state.normals, film_state.albedo,
                 variance=film_variance(film_state), iterations=iterations)
