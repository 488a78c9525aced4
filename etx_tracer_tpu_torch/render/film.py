"""Film layers (counterpart of `etx_tracer_tpu/render/film.py`).

The camera layer is a running mean over full-film iterations; the light
layer averages each iteration's light-tracing splat image (VCM, BDPT and
light tracing); `variance_half` is the mean of the even iterations, which
the adaptive render compares with the full mean. All float32, in the JAX
package's order of operations.

Row convention: row index py=0 is the BOTTOM of the image (NDC v=-1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# luminance weights of the noise estimate
_LUM = (0.212671, 0.715160, 0.072169)


class FilmState(NamedTuple):
  camera: torch.Tensor          # (H,W,3) running mean
  variance_half: torch.Tensor   # (H,W,3) mean of every-other sample (noise estimate)
  normals: torch.Tensor         # (H,W,3)
  albedo: torch.Tensor          # (H,W,3)
  light: torch.Tensor           # (H,W,3) light-tracing image (zero for PT)
  light_iteration: torch.Tensor  # (H,W,3)
  iteration: torch.Tensor       # () int32 completed iterations


def allocate(width: int, height: int, device) -> FilmState:
  z = torch.zeros((height, width, 3), device=device)
  return FilmState(z, z, z, z, z, z, torch.zeros((), dtype=torch.int32, device=device))


def accumulate_camera(state: FilmState, colors, normals, albedos) -> FilmState:
  """Running-mean accumulation of one full-film iteration ((H,W,3) each);
  the variance layer takes the even iterations at double weight."""
  it = state.iteration.to(torch.float32)
  t = 1.0 / (it + 1.0)
  cam = state.camera + (colors - state.camera) * t
  nrm = state.normals + (normals - state.normals) * t
  alb = state.albedo + (albedos - state.albedo) * t
  use = (state.iteration % 2) == 0
  t2 = torch.where(use, 2.0 / (it + 2.0), 0.0)
  vh = state.variance_half + (colors - state.variance_half) * t2
  return state._replace(camera=cam, normals=nrm, albedo=alb, variance_half=vh,
                        iteration=state.iteration + 1)


def accumulate_camera_masked(state: FilmState, colors, counts, active):
  """Per-pixel running mean for adaptive passes: pixels outside `active`
  ((H,W) bool) keep their means and tallies. counts: (H,W) samples folded
  so far. Returns (new_state, new_counts); the iteration counter advances."""
  a = active.to(torch.float32)[..., None]
  c = counts[..., None]
  t = a / (c + 1.0)
  cam = state.camera + (colors - state.camera) * t
  even = ((counts % 2.0) == 0.0)[..., None]
  t2 = torch.where(even, 2.0 / (c + 2.0), 0.0) * a
  vh = state.variance_half + (colors - state.variance_half) * t2
  return (state._replace(camera=cam, variance_half=vh, iteration=state.iteration + 1),
          counts + active.to(torch.float32))


def splat_light(state: FilmState, ndc_uv, values) -> FilmState:
  """Add light-tracing contributions (R,3) at NDC positions (R,2) into the
  iteration buffer; positions off the film are dropped."""
  h, w, _ = state.light_iteration.shape
  uv = ndc_uv * 0.5 + 0.5
  x = (uv[..., 0] * w).to(torch.int64)
  y = (uv[..., 1] * h).to(torch.int64)
  ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
  x = torch.clamp(x, 0, w - 1)
  y = torch.clamp(y, 0, h - 1)
  vals = torch.where(ok[..., None], values, 0.0)
  li = state.light_iteration.reshape(h * w, 3).index_add(0, y * w + x, vals)
  return state._replace(light_iteration=li.reshape(h, w, 3))


def commit_light_iteration(state: FilmState) -> FilmState:
  """Fold the iteration's splat buffer into the averaged light image."""
  t = 1.0 / (state.iteration.to(torch.float32) + 1.0)
  light = state.light + (state.light_iteration - state.light) * t
  return state._replace(light=light, light_iteration=torch.zeros_like(state.light_iteration))


def result_image(state: FilmState) -> torch.Tensor:
  """Camera + light layers combined."""
  return state.camera + state.light


def _lum(v: torch.Tensor) -> torch.Tensor:
  return v[..., 0] * _LUM[0] + v[..., 1] * _LUM[1] + v[..., 2] * _LUM[2]


def noise_estimate(state: FilmState) -> torch.Tensor:
  """Per-pixel relative deviation between the full and the half means."""
  lum_full = _lum(state.camera)
  lum_half = _lum(state.variance_half)
  return torch.abs(lum_full - lum_half) / torch.clamp(torch.abs(lum_full), min=1e-4)


def dilate_mask(active: torch.Tensor, k: int = 5) -> torch.Tensor:
  """k x k block dilation of an (H,W) bool map."""
  h, w = active.shape
  pad = k // 2
  act = torch.nn.functional.pad(active, (pad, pad, pad, pad))
  out = torch.zeros_like(active)
  for dy in range(k):
    for dx in range(k):
      out = out | act[dy:dy + h, dx:dx + w]
  return out


def _hsv_to_rgb(h, s, v):
  i = torch.floor(h * 6.0)
  f = h * 6.0 - i
  p = v * (1.0 - s)
  q = v * (1.0 - f * s)
  t = v * (1.0 - (1.0 - f) * s)
  i = i.to(torch.int32) % 6

  def pick(*by_sector):
    out = by_sector[5]
    for k in range(4, -1, -1):
      out = torch.where(i == k, by_sector[k], out)
    return out

  return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)],
                     dim=-1)


def sample_heatmap(counts, min_samples: int = 4) -> torch.Tensor:
  """Debug layer: a heat map of per-pixel sample counts ((H,W)), blue (hue
  2/3) at `min_samples`, red (hue 0) at the largest count; all blue when no
  count exceeds `min_samples`. Returns (H,W,3)."""
  counts = torch.as_tensor(counts, dtype=torch.float32)
  max_c = counts.max()
  t = torch.where(max_c > min_samples,
                  torch.clamp((counts - min_samples) / torch.clamp(max_c - min_samples, min=1e-6),
                              0.0, 1.0),
                  0.0)
  hue = (2.0 / 3.0) * (1.0 - t)
  one = torch.ones_like(hue)
  return _hsv_to_rgb(hue, one, one)
