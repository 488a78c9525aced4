"""Emitter sampling and radiance evaluation.

Counterpart of `etx_tracer_tpu/render/emitters.py`: `sample_emitter_index`,
`discrete_pdf`, `sample_emitter` (NEE toward an area emitter, a directional
sun disk or an environment, the environment importance-sampled through its
image), `area_radiance`, `sample_emission` (a light path's start) and
`env_contribution` (what a missed ray gathers from the distant emitters,
with its MIS weight), in RGB and spectral mode: a spectral lane reads the
emitter's SPD at its wavelength. Every class is evaluated over the whole
wavefront and picked per lane; `classes` leaves out the distant branches
of a scene lit by area emitters only. Record lookups index the packed
tables (scene/packed.py). As in the JAX package, a directional NEE sample
carries the emission spectrum without the sun image, and a light path
from an environment carries the spectrum without the map.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from etx_tracer_tpu_torch.core import distribution as distlib
from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.render import images as images_mod
from etx_tracer_tpu_torch.render import spectral as spx
from etx_tracer_tpu_torch.scene import packed
from etx_tracer_tpu_torch.scene.types import EmitterClass

_COLLIMATION = packed.mat_column("emission_collimation")
_EXT_MEDIUM = packed.mat_column("ext_medium")


class EmitterSample(NamedTuple):
  value: torch.Tensor        # (R,C) radiance
  origin: torch.Tensor       # (R,3) point on the emitter
  normal: torch.Tensor       # (R,3)
  direction: torch.Tensor    # (R,3) from the shading point toward the emitter
  pdf_sample: torch.Tensor   # (R,) discrete selection pdf
  pdf_area: torch.Tensor     # (R,)
  pdf_dir: torch.Tensor      # (R,) solid-angle pdf
  pdf_dir_out: torch.Tensor  # (R,)
  is_delta: torch.Tensor     # (R,) bool
  emitter_index: torch.Tensor  # (R,)
  triangle_index: torch.Tensor  # (R,) int32


def collimation_to_exponent(c: torch.Tensor) -> torch.Tensor:
  t = em.saturate(c)
  return 1.0 / torch.clamp(em.sqr(em.sqr(1.0 - t)), min=em.kEpsilon)


def sample_emitter_index(scene, rnd: torch.Tensor):
  """Power-CDF emitter selection; returns (index, pdf)."""
  return distlib.sample(scene.emitters.cdf, scene.emitters.pdf, rnd)


def discrete_pdf(scene, emitter_index: torch.Tensor) -> torch.Tensor:
  w = scene.em_table[emitter_index, 3]
  return w / torch.clamp(scene.emitters.total_weight, min=1e-20)


def _collimation(scene, trows) -> torch.Tensor:
  return scene.mat_table[trows.mat, _COLLIMATION]


def sample_emitter(scene, emitter_index: torch.Tensor, rnd2: torch.Tensor,
                   from_point: torch.Tensor, wl=None, spectral: bool = False,
                   classes: tuple = (0, 1, 2)) -> EmitterSample:
  """A point on the selected emitter as seen from `from_point`: on an area
  emitter's triangle, or on the bounding sphere along a direction within a
  directional emitter's disk or drawn from an environment (through its
  image's distribution, uniformly over the sphere without one). `classes`
  (the scene's `emitter_classes`) = (Area,) computes the area branch only."""
  erows = packed.EmitterRows(scene.em_table[emitter_index])
  prows = packed.ProfileRows(scene.prof_table[erows.profile])
  tri = torch.clamp(erows.triangle, min=0)
  trows = packed.TriRows(scene.tri_table[tri])

  # ---- area emitters ----
  bc = em.random_barycentric(rnd2)
  origin_a = (scene.tri_v0[tri] + bc[..., 1:2] * scene.tri_e1[tri]
              + bc[..., 2:3] * scene.tri_e2[tri])
  normal_a = em.normalize(trows.n0 * bc[..., 0:1] + trows.n1 * bc[..., 1:2]
                          + trows.n2 * bc[..., 2:3])
  dir_a = em.normalize(origin_a - from_point)
  geo_n = trows.geo_n

  facing = em.dot(geo_n, origin_a - from_point) < 0.0
  pdf_area_a = 1.0 / torch.clamp(erows.triangle_area, min=1e-12)
  dp = from_point - origin_a
  dist2 = em.dot(dp, dp)
  cos_t = torch.abs(em.dot(dp, geo_n)) / torch.clamp(torch.sqrt(dist2), min=1e-12)
  exponent = collimation_to_exponent(_collimation(scene, trows))
  cos_tx = torch.pow(torch.clamp(cos_t, min=1e-9), exponent)
  has_dir = (dist2 > 0.0) & (cos_tx > em.kEpsilon)
  pdf_dir_a = torch.where(has_dir, pdf_area_a * dist2 / torch.clamp(cos_tx, min=1e-12), 0.0)
  pdf_dir_out_a = torch.where(has_dir, pdf_area_a * cos_tx * em.kInvPi, 0.0)
  emission = spx.query_spd(scene, prows.emission_spec, wl, spectral)
  value_a = torch.where(facing[..., None], emission, 0.0)
  pdf_dir_a = torch.where(facing, pdf_dir_a, 0.0)
  pdf_sample = discrete_pdf(scene, emitter_index)

  if tuple(classes) == (EmitterClass.Area,):
    return EmitterSample(
        value=value_a, origin=origin_a, normal=normal_a, direction=dir_a,
        pdf_sample=pdf_sample, pdf_area=pdf_area_a, pdf_dir=pdf_dir_a,
        pdf_dir_out=pdf_dir_out_a, is_delta=torch.zeros_like(facing),
        emitter_index=emitter_index, triangle_index=erows.triangle)

  center, radius = scene.bsphere_center, scene.bsphere_radius
  # ---- directional emitters: a direction within the disk ----
  pdir = prows.direction
  disk = prows.equivalent_disk_size
  u, v = em.orthonormal_basis(pdir)
  ds = em.sample_disk(rnd2)
  dir_d = em.normalize(pdir + u * (ds[..., 0:1] * 0.5 * disk[..., None])
                       + v * (ds[..., 1:2] * 0.5 * disk[..., None]))
  dir_d = torch.where((prows.angular_size > 0.0)[..., None], dir_d, pdir)
  pdf_area_d = 1.0 / (em.kPi * em.sqr(radius))
  origin_d = from_point + dir_d * em.distance_to_sphere(from_point, dir_d, center,
                                                        radius)[..., None]

  # ---- environments: the image's distribution, else the uniform sphere ----
  z = 1.0 - 2.0 * rnd2[..., 0]
  phi = em.kDoublePi * rnd2[..., 1]
  s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
  dir_uniform = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
  pdf_uniform = 1.0 / (2.0 * em.kDoublePi)
  if images_mod.bank_is_empty(scene.images):
    dir_e = dir_uniform
    pdf_dir_e = torch.full_like(z, pdf_uniform)
    value_e = emission
  else:
    bank = scene.images
    has_img = prows.emission_img >= 0
    img = torch.clamp(prows.emission_img, min=0)
    img_uv, img_pdf = images_mod.sample(bank, img, rnd2)
    dir_img = em.uv_to_direction(img_uv, bank.offset[img, 0], bank.scale_u[img])
    sin_t = torch.clamp(torch.sin(img_uv[..., 1] * em.kPi), min=em.kEpsilon)
    pdf_img = img_pdf / (2.0 * em.kPi * em.kPi * sin_t)
    rgb = images_mod.evaluate(bank, img, img_uv)[:, :3]
    value_img = spx.apply_rgb(emission, rgb, wl, spectral)
    dir_e = torch.where(has_img[..., None], dir_img, dir_uniform)
    pdf_dir_e = torch.where(has_img, pdf_img, pdf_uniform)
    value_e = torch.where(has_img[..., None], value_img, emission)
  origin_e = from_point + dir_e * em.distance_to_sphere(from_point, dir_e, center,
                                                        radius)[..., None]

  is_area = erows.cls == EmitterClass.Area
  is_dir = erows.cls == EmitterClass.Directional
  is_env = erows.cls == EmitterClass.Environment
  a3, d3 = is_area[..., None], is_dir[..., None]
  pdf_dir = torch.where(is_area, pdf_dir_a, torch.where(is_dir, 1.0, pdf_dir_e))
  return EmitterSample(
      value=torch.where(a3, value_a, torch.where(d3, emission,
                                                 torch.where(is_env[..., None], value_e, 0.0))),
      origin=torch.where(a3, origin_a, torch.where(d3, origin_d, origin_e)),
      normal=torch.where(a3, normal_a, torch.where(d3, -pdir, -dir_e)),
      direction=torch.where(a3, dir_a, torch.where(d3, dir_d, dir_e)),
      pdf_sample=pdf_sample,
      pdf_area=torch.where(is_area, pdf_area_a, pdf_area_d),
      pdf_dir=pdf_dir,
      pdf_dir_out=torch.where(is_area, pdf_dir_out_a, pdf_dir * pdf_area_d),
      is_delta=is_dir, emitter_index=emitter_index, triangle_index=erows.triangle)


def area_radiance(scene, emitter_index, ray_origin, hit_pos, directly_visible, wl=None,
                  spectral: bool = False):
  """Radiance of a hit area emitter: (value (R,C), pdf_area, pdf_dir,
  pdf_dir_out); zero where emitter_index < 0 or on the back side."""
  valid = emitter_index >= 0
  erows = packed.EmitterRows(scene.em_table[torch.clamp(emitter_index, min=0)])
  tri = torch.clamp(erows.triangle, min=0)
  trows = packed.TriRows(scene.tri_table[tri])
  geo_n = trows.geo_n

  facing = em.dot(geo_n, hit_pos - ray_origin) < 0.0
  pdf_area = 1.0 / torch.clamp(erows.triangle_area, min=1e-12)
  dp = ray_origin - hit_pos
  dist2 = em.dot(dp, dp)
  cos_t = (torch.abs(em.dot(dp, geo_n))
           / torch.clamp(torch.sqrt(torch.clamp(dist2, min=1e-20)), min=1e-12))
  exponent = collimation_to_exponent(_collimation(scene, trows))
  cos_tx = torch.where(directly_visible, cos_t,
                       torch.pow(torch.clamp(cos_t, min=1e-9), exponent))
  has = (dist2 > 0.0) & (cos_tx > em.kEpsilon)
  pdf_dir = torch.where(has, pdf_area * dist2 / torch.clamp(cos_tx, min=1e-12), 0.0)
  pdf_dir_out = torch.where(has, pdf_area * cos_tx * em.kInvPi, 0.0)

  prof_spec = scene.prof_table[erows.profile, 1].to(torch.int32)
  value = spx.query_spd(scene, prof_spec, wl, spectral)
  ok = valid & facing
  return (torch.where(ok[..., None], value, 0.0),
          torch.where(ok, pdf_area, 0.0),
          torch.where(ok, pdf_dir, 0.0),
          torch.where(ok, pdf_dir_out, 0.0))


class EmissionSample(NamedTuple):
  """A light path's origin and first direction."""
  value: torch.Tensor        # (R,C)
  origin: torch.Tensor       # (R,3)
  normal: torch.Tensor       # (R,3)
  direction: torch.Tensor    # (R,3) emitted direction
  pdf_sample: torch.Tensor   # (R,)
  pdf_area: torch.Tensor     # (R,)
  pdf_dir: torch.Tensor      # (R,)
  pdf_dir_out: torch.Tensor  # (R,)
  is_delta: torch.Tensor     # (R,) bool
  is_distant: torch.Tensor   # (R,) bool
  triangle_index: torch.Tensor  # (R,) int32
  medium_index: torch.Tensor  # (R,) int32 the emitting material's exterior medium
  geo_n: torch.Tensor        # (R,3) the emitter triangle's geometric normal


def sample_emission(scene, rnd_sel, rnd_pos, rnd_dir, wl=None,
                    spectral: bool = False) -> EmissionSample:
  """A light path's origin and direction (power-CDF selection): a uniform
  point on an area emitter's triangle with a cosine-power direction about
  its shading normal, the path starting in the emitting material's
  exterior medium; from a directional emitter, a point of the bounding
  sphere's disk facing it and a direction within its disk; from an
  environment, a uniform inward direction and a point of the sphere's disk
  across it. The value is the emission spectrum for every class."""
  emitter_index, _ = sample_emitter_index(scene, rnd_sel)
  erows = packed.EmitterRows(scene.em_table[emitter_index])
  prows = packed.ProfileRows(scene.prof_table[erows.profile])
  tri = torch.clamp(erows.triangle, min=0)
  trows = packed.TriRows(scene.tri_table[tri])
  emission = spx.query_spd(scene, prows.emission_spec, wl, spectral)

  # ---- area: a cosine-power direction from a surface point ----
  bc = em.random_barycentric(rnd_pos)
  origin_a = (scene.tri_v0[tri] + bc[..., 1:2] * scene.tri_e1[tri]
              + bc[..., 2:3] * scene.tri_e2[tri])
  w0, w1, w2 = bc[..., 0:1], bc[..., 1:2], bc[..., 2:3]
  normal_a = em.normalize(trows.n0 * w0 + trows.n1 * w1 + trows.n2 * w2)
  tan = em.normalize(trows.t0 * w0 + trows.t1 * w1 + trows.t2 * w2)
  btn = em.normalize(trows.b0 * w0 + trows.b1 * w1 + trows.b2 * w2)
  mrows = scene.mat_table[trows.mat]
  ext_medium = mrows[:, _EXT_MEDIUM].to(torch.int32)
  exponent = collimation_to_exponent(mrows[:, _COLLIMATION])
  local = em.sample_cosine_distribution(rnd_dir, exponent)
  dir_a = tan * local[..., 0:1] + btn * local[..., 1:2] + normal_a * local[..., 2:3]
  pdf_dir_a = torch.clamp(em.dot(normal_a, dir_a), min=0.0) * em.kInvPi
  pdf_area_a = 1.0 / torch.clamp(erows.triangle_area, min=1e-12)

  # ---- directional: from the bounding sphere's disk, within the sun's disk ----
  center, radius = scene.bsphere_center, scene.bsphere_radius
  to_scene = -prows.direction
  u, v = em.orthonormal_basis(to_scene)
  ps = em.sample_disk(rnd_pos)
  ds = em.sample_disk(rnd_dir)
  disk = prows.equivalent_disk_size
  dir_d = em.normalize(to_scene + u * (ds[..., 0:1] * 0.5 * disk[..., None])
                       + v * (ds[..., 1:2] * 0.5 * disk[..., None]))
  origin_d = center + radius * (ps[..., 0:1] * u + ps[..., 1:2] * v - to_scene)
  origin_d = origin_d + dir_d * em.distance_to_sphere(origin_d, dir_d, center,
                                                      radius)[..., None]
  pdf_area_sph = 1.0 / (em.kPi * em.sqr(radius))

  # ---- environment: a uniform direction inward from the sphere ----
  z = 1.0 - 2.0 * rnd_dir[..., 0]
  phi = em.kDoublePi * rnd_dir[..., 1]
  s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
  dir_env = -torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
  ue, ve = em.orthonormal_basis(dir_env)
  origin_e = center + radius * (ps[..., 0:1] * ue + ps[..., 1:2] * ve - dir_env)
  origin_e = origin_e + dir_env * em.distance_to_sphere(origin_e, dir_env, center,
                                                        radius)[..., None]

  is_area = erows.cls == EmitterClass.Area
  is_dir = erows.cls == EmitterClass.Directional
  a3, d3 = is_area[..., None], is_dir[..., None]
  pdf_dir = torch.where(is_area, pdf_dir_a,
                        torch.where(is_dir, 1.0, 1.0 / (2.0 * em.kDoublePi)))
  return EmissionSample(
      value=emission,
      origin=torch.where(a3, origin_a, torch.where(d3, origin_d, origin_e)),
      normal=torch.where(a3, normal_a, torch.where(d3, to_scene, dir_env)),
      direction=torch.where(a3, dir_a, torch.where(d3, dir_d, dir_env)),
      pdf_sample=discrete_pdf(scene, emitter_index),
      pdf_area=torch.where(is_area, pdf_area_a, pdf_area_sph),
      pdf_dir=pdf_dir,
      pdf_dir_out=torch.where(is_area, pdf_dir_a * pdf_area_a, pdf_dir * pdf_area_sph),
      is_delta=is_dir, is_distant=~is_area,
      triangle_index=erows.triangle,
      medium_index=torch.where(is_area, ext_medium, -1),
      geo_n=trows.geo_n)


def env_contribution(scene, direction: torch.Tensor, wl, directly_visible: torch.Tensor,
                     mis_flag: torch.Tensor, bsdf_pdf: torch.Tensor, num_env: int,
                     spectral: bool = False) -> torch.Tensor:
  """What rays missing the scene along `direction` gather from the scene's
  `num_env` distant emitters (`emitters.env_indices`), each with its MIS
  weight against NEE (none for a directly visible ray or a lane whose
  `mis_flag` is off): (R,C), to be scaled by the path throughput. A
  directional emitter shows only to directly visible rays inside its disk,
  with radiance 1 over the disk's solid angle (the spectrum cancels against
  the camera's scale); an environment gives its image's radiance times its
  spectrum (the spectrum alone without an image), with the image's
  sampling pdf."""
  r = direction.shape[0]
  total = torch.zeros((r, spx.channels(spectral)), device=direction.device)
  bank = scene.images
  for slot in range(num_env):
    ei = scene.emitters.env_indices[slot]
    valid = ei >= 0
    ei_s = torch.clamp(ei, min=0).to(torch.int64)
    erow = scene.em_table[ei_s]
    prow = scene.prof_table[erow[1].to(torch.int64)]
    spec = prow[1].to(torch.int32).expand(r)
    value = spx.query_spd(scene, spec, wl, spectral)

    # directional: the sun disk, seen directly
    ang_cos = prow[8]
    cos_d = em.dot(direction, prow[3:6])
    dir_ok = directly_visible & (prow[6] > 0.0) & (cos_d >= ang_cos)
    disk_norm = 1.0 / (em.kDoublePi * torch.clamp(1.0 - ang_cos, min=1e-9))
    pdf_dir_d = torch.where(dir_ok, 1.0, 0.0)

    # environment: the image's radiance and pdf, else the spectrum
    pdf_uniform = 1.0 / (2.0 * em.kDoublePi)
    if images_mod.bank_is_empty(bank):
      value_env = value
      pdf_dir_e = torch.full((r,), pdf_uniform, device=direction.device)
    else:
      img = prow[2].to(torch.int64)
      has_img = img >= 0
      img_lanes = torch.clamp(img, min=0).expand(r)
      uv_env = em.direction_to_uv(direction, bank.offset[img_lanes, 0], bank.scale_u[img_lanes])
      rgb = images_mod.evaluate(bank, img_lanes, uv_env)[:, :3]
      value_img = spx.apply_rgb(value, rgb, wl, spectral)
      sin_t = torch.clamp(torch.sin(uv_env[..., 1] * em.kPi), min=em.kEpsilon)
      pdf_img = images_mod.pdf_at(bank, img_lanes, uv_env) / (2.0 * em.kPi * em.kPi * sin_t)
      value_env = torch.where(has_img, value_img, value)
      pdf_dir_e = torch.where(has_img, pdf_img, pdf_uniform)

    is_dir = erow[0] == EmitterClass.Directional
    v = torch.where(is_dir, disk_norm * pdf_dir_d[..., None], value_env)
    pdf_dir = torch.where(is_dir, pdf_dir_d, pdf_dir_e)
    no_weight = ~mis_flag | directly_visible
    weight = torch.where(no_weight, 1.0,
                         em.power_heuristic(bsdf_pdf, discrete_pdf(scene, ei_s) * pdf_dir))
    total = total + torch.where((valid & (pdf_dir > 0.0))[..., None], v * weight[..., None], 0.0)
  return total
