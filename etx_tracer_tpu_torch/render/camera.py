"""Camera ray generation and film sampling.

Counterpart of `etx_tracer_tpu/render/camera.py`: ray generation for a
pinhole, a thin lens (depth of field, its aperture a disk or shaped by an
image of the bank) and an equirectangular camera, the pixel filter, and
the light-to-camera connection of the bidirectional integrators
(`sample_film`, `film_pdf_out`). Whether the lens is on and which image
shapes it are read on the host once per render (`lens_of`), so a camera
without a lens computes no lens arithmetic.
Pixel convention: pixel (px, py) with py=0 at the BOTTOM row of the film
arrays (NDC v = -1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.render import images as images_mod

# Radial Blackman-Harris pixel filter: the inverse radial CDF as a piecewise
# polynomial fit (the JAX package's constants).
_BH_SPLIT = 0.90
_BH_MAIN = np.array([19.85930973, -70.57191808, 105.75280208, -86.13626149,
                     41.3327709, -11.74788296, 1.97336551, -0.09055742,
                     0.16622468, -5.155e-05], np.float32)
_BH_TAIL = np.array([0.96960741, 3.9751558, -33.19148686, 109.26038337,
                     -170.57134179, 103.87089986], np.float32)


def blackman_harris_jitter(rnd2: torch.Tensor) -> torch.Tensor:
  """Pixel-filter jitter in [-1,1]^2 with the radial Blackman-Harris
  distribution."""
  phi = 2.0 * em.kPi * rnd2[..., 0]
  t = rnd2[..., 1]
  g = torch.zeros_like(t)
  for c in _BH_MAIN.tolist():
    g = g * t + c
  d_main = torch.sqrt(torch.clamp(g, min=0.0))
  s = torch.clamp(1.0 - t, min=0.0)
  s3 = torch.pow(s, 1.0 / 3.0)  # cube root (s >= 0)
  c = _BH_TAIL.tolist()
  one_minus = (c[0] * s3 + c[1] * s3 * s3 + c[2] * s
               + c[3] * s * s3 + c[4] * s * s3 * s3
               + c[5] * s * s)
  d_tail = 1.0 - one_minus
  d = torch.clamp(torch.where(t > _BH_SPLIT, d_tail, d_main), 0.0, 1.0)
  return torch.stack([d * torch.cos(phi), d * torch.sin(phi)], dim=-1)


def pixel_jitter(pixel_filter: str, jit_rnd: torch.Tensor, iteration: torch.Tensor) -> torch.Tensor:
  """Per-sample in-pixel jitter for the reconstruction filter.

  "blackman-harris": radial BH importance sample, pixel centers on
  iteration 0. "box": uniform over the pixel. "center": pixel centers.
  """
  if pixel_filter == "center":
    return torch.zeros_like(jit_rnd)
  if pixel_filter == "box":
    return jit_rnd - 0.5
  if pixel_filter != "blackman-harris":
    raise ValueError(f"unknown pixel_filter {pixel_filter!r}")
  return torch.where((iteration == 0)[..., None], 0.0, blackman_harris_jitter(jit_rnd))


def film_uv(px, py, width: int, height: int, jitter: torch.Tensor) -> torch.Tensor:
  """Pixel + jitter -> NDC uv in [-1, 1]."""
  u = (px.to(torch.float32) + 0.5 + jitter[..., 0]) / width * 2.0 - 1.0
  v = (py.to(torch.float32) + 0.5 + jitter[..., 1]) / height * 2.0 - 1.0
  return torch.stack([u, v], dim=-1)


class RayBundle(NamedTuple):
  o: torch.Tensor      # (R,3)
  d: torch.Tensor      # (R,3)
  t_min: torch.Tensor  # (R,)
  t_max: torch.Tensor  # (R,)


class Lens(NamedTuple):
  """What ray generation needs to know of the lens on the host."""
  dof: bool   # lens_radius and focal_distance above kEpsilon
  image: int  # the bank image that shapes the aperture, -1: a disk


def lens_of(camera) -> Lens:
  """The camera's lens, read from the card (two host reads)."""
  dof = (camera.lens_radius > em.kEpsilon) & (camera.focal_distance > em.kEpsilon)
  return Lens(bool(dof.item()), int(camera.lens_image.item()))


def generate_ray(camera, uv: torch.Tensor, lens_rnd=None, lens: Lens | None = None,
                 bank=None, equirectangular: bool = False) -> RayBundle:
  """Camera ray for NDC uv. `equirectangular`: uv in [-1, 1]^2 is
  longitude x latitude from the camera position. With `lens.dof`, the ray
  leaves a point of the lens (a disk sample of `lens_rnd`, or the
  importance sample of `bank`'s image `lens.image` mapped to [-1, 1]^2)
  scaled by the lens radius, toward the pinhole ray's point at the focal
  distance. A `lens` of None is a pinhole."""
  r = uv.shape[0]
  origin = camera.position.expand(r, 3)
  if equirectangular:
    d = em.from_spherical(uv[..., 0] * em.kPi, uv[..., 1] * em.kHalfPi)
    return RayBundle(origin, d, torch.full((r,), em.kRayEpsilon, device=uv.device),
                     torch.full((r,), em.kMaxFloat, device=uv.device))
  s = uv[..., 0:1] * camera.side
  u = uv[..., 1:2] * camera.up / camera.aspect
  w_o = em.normalize(camera.tan_half_fov * (s + u) + camera.direction)
  if lens is not None and lens.dof:
    if lens.image >= 0:
      img = torch.full((r,), lens.image, dtype=torch.int64, device=uv.device)
      sensor = images_mod.sample(bank, img, lens_rnd)[0] * 2.0 - 1.0
    else:
      sensor = em.sample_disk(lens_rnd)
    sensor = sensor * camera.lens_radius
    origin = origin + camera.side * sensor[..., 0:1] + camera.up * sensor[..., 1:2]
    focal_t = camera.focal_distance / torch.clamp(em.dot(w_o, camera.direction), min=1e-6)
    focus_p = camera.position + focal_t[..., None] * w_o
    w_o = em.normalize(focus_p - origin)
  cos_t = em.dot(w_o, camera.direction)
  t_near = torch.where(camera.clip_near > 0.0, camera.clip_near / cos_t, em.kRayEpsilon)
  t_far = torch.where(camera.clip_far > 0.0, camera.clip_far / cos_t, em.kMaxFloat)
  return RayBundle(origin, w_o, torch.clamp(t_near, min=em.kRayEpsilon), t_far)


class FilmSample(NamedTuple):
  """A light-to-camera connection: the lens point, its normal, the unit
  direction from the scene point to it, the NDC position, the importance
  weight and solid-angle pdf, and whether it lands on the film."""
  position: torch.Tensor   # (R,3)
  normal: torch.Tensor     # (R,3)
  direction: torch.Tensor  # (R,3)
  uv: torch.Tensor         # (R,2)
  weight: torch.Tensor     # (R,)
  pdf_dir: torch.Tensor    # (R,)
  valid: torch.Tensor      # (R,) bool


def sample_film(camera, from_point: torch.Tensor, lens_rnd: torch.Tensor) -> FilmSample:
  """Connect world points to the camera (light tracing, BDPT and VCM). The
  lens arithmetic is the JAX package's; a pinhole (lens_radius 0) connects
  to the camera position."""
  sensor = em.sample_disk(lens_rnd) * camera.lens_radius
  use_dof = (camera.lens_radius > em.kEpsilon) & (camera.focal_distance > em.kEpsilon)
  sensor = torch.where(use_dof, sensor, 0.0)

  position = camera.position + sensor[..., 0:1] * camera.side + sensor[..., 1:2] * camera.up
  direction = position - from_point
  normal = camera.direction
  cos_t = -em.dot(direction, normal)
  dist2 = em.dot(direction, direction)
  dist = torch.sqrt(torch.clamp(dist2, min=1e-30))
  direction = direction / dist[..., None]
  cos_t = cos_t / dist

  focal = torch.where(use_dof, camera.focal_distance, 1.0)
  focus = position - direction * (focal / torch.clamp(cos_t, min=1e-6))[..., None]
  # view_proj @ [focus, 1], each row summed in component order
  m = camera.view_proj
  proj = [focus[..., 0] * m[i, 0] + focus[..., 1] * m[i, 1] + focus[..., 2] * m[i, 2] + m[i, 3]
          for i in range(4)]
  w = proj[3]
  w_safe = torch.where(w == 0, 1.0, w)
  uv = torch.stack([proj[0] / w_safe, proj[1] / w_safe], dim=-1)

  in_frustum = (w > 0.0) & (torch.abs(uv[..., 0]) <= 1.0) & (torch.abs(uv[..., 1]) <= 1.0)
  valid = (cos_t > 0.0) & in_frustum

  lens_area = torch.where(camera.lens_radius > em.kEpsilon,
                          em.kPi * em.sqr(camera.lens_radius), 1.0)
  pdf_area = 1.0 / lens_area
  cos_c = torch.clamp(cos_t, min=1e-9)
  pdf_dir = pdf_area * dist2 / cos_c
  pdf_dir_out = 1.0 / (camera.area * lens_area * (cos_c * cos_c * cos_c))
  importance = pdf_dir_out / cos_c
  weight = importance / torch.clamp(pdf_dir, min=1e-30)
  return FilmSample(
      position=position.expand(from_point.shape), normal=normal.expand(from_point.shape),
      direction=direction, uv=uv,
      weight=torch.where(valid, weight, 0.0),
      pdf_dir=torch.where(valid, pdf_dir, 0.0),
      valid=valid)


def film_pdf_out(camera, to_point: torch.Tensor) -> torch.Tensor:
  """The camera's directional pdf toward each point (per unit image area)."""
  w_i = em.normalize(to_point - camera.position)
  cos_t = em.dot(w_i, camera.direction)
  return 1.0 / torch.abs(camera.area * (cos_t * cos_t * cos_t))
