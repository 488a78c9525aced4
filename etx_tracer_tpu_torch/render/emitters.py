"""Area-emitter sampling and radiance evaluation.

Counterpart of the area-emitter parts of `etx_tracer_tpu/render/emitters.py`
(`sample_emitter_index`, `discrete_pdf`, `sample_emitter` with only the Area
class, `area_radiance`, and `sample_emission`, a light path's start, with
only the Area class), in RGB and spectral mode: a spectral lane reads the
emitter's SPD (the blackbody light of the Cornell box) at its wavelength.
Environment and directional emitters are a later slice. Record lookups
index the packed tables (scene/packed.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from etx_tracer_tpu_torch.core import distribution as distlib
from etx_tracer_tpu_torch.core import math as em
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
                   from_point: torch.Tensor, wl=None, spectral: bool = False) -> EmitterSample:
  """A point on the selected area emitter as seen from `from_point`."""
  erows = packed.EmitterRows(scene.em_table[emitter_index])
  prows = packed.ProfileRows(scene.prof_table[erows.profile])
  tri = torch.clamp(erows.triangle, min=0)
  trows = packed.TriRows(scene.tri_table[tri])

  bc = em.random_barycentric(rnd2)
  origin = (scene.tri_v0[tri] + bc[..., 1:2] * scene.tri_e1[tri]
            + bc[..., 2:3] * scene.tri_e2[tri])
  normal = em.normalize(trows.n0 * bc[..., 0:1] + trows.n1 * bc[..., 1:2]
                        + trows.n2 * bc[..., 2:3])
  direction = em.normalize(origin - from_point)
  geo_n = trows.geo_n

  facing = em.dot(geo_n, origin - from_point) < 0.0
  pdf_area = 1.0 / torch.clamp(erows.triangle_area, min=1e-12)
  dp = from_point - origin
  dist2 = em.dot(dp, dp)
  cos_t = torch.abs(em.dot(dp, geo_n)) / torch.clamp(torch.sqrt(dist2), min=1e-12)
  exponent = collimation_to_exponent(_collimation(scene, trows))
  cos_tx = torch.pow(torch.clamp(cos_t, min=1e-9), exponent)
  has_dir = (dist2 > 0.0) & (cos_tx > em.kEpsilon)
  pdf_dir = torch.where(has_dir, pdf_area * dist2 / torch.clamp(cos_tx, min=1e-12), 0.0)
  pdf_dir_out = torch.where(has_dir, pdf_area * cos_tx * em.kInvPi, 0.0)
  emission = spx.query_spd(scene, prows.emission_spec, wl, spectral)
  return EmitterSample(
      value=torch.where(facing[..., None], emission, 0.0),
      origin=origin, normal=normal, direction=direction,
      pdf_sample=discrete_pdf(scene, emitter_index),
      pdf_area=pdf_area, pdf_dir=torch.where(facing, pdf_dir, 0.0),
      pdf_dir_out=pdf_dir_out,
      is_delta=torch.zeros_like(facing),
      emitter_index=emitter_index, triangle_index=erows.triangle)


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


def check_area_emitters(scene) -> None:
  """Raise NotImplementedError unless every emitter is an area emitter
  (directional and environment emitters are ROADMAP Queue 1 item 6)."""
  if bool((scene.em_table[:, 0] != EmitterClass.Area).any().item()):
    raise NotImplementedError(
        "directional and environment emitters: a later slice (ROADMAP Queue 1 item 6)")


def sample_emission(scene, rnd_sel, rnd_pos, rnd_dir, wl=None,
                    spectral: bool = False) -> EmissionSample:
  """A light path's origin on an area emitter (power-CDF selection, a
  uniform point on its triangle) and a cosine-power direction about the
  shading normal; the path starts in the emitting material's exterior
  medium. The scene must hold area emitters only (`check_area_emitters`)."""
  emitter_index, _ = sample_emitter_index(scene, rnd_sel)
  erows = packed.EmitterRows(scene.em_table[emitter_index])
  prows = packed.ProfileRows(scene.prof_table[erows.profile])
  tri = torch.clamp(erows.triangle, min=0)
  trows = packed.TriRows(scene.tri_table[tri])
  emission = spx.query_spd(scene, prows.emission_spec, wl, spectral)

  bc = em.random_barycentric(rnd_pos)
  origin = (scene.tri_v0[tri] + bc[..., 1:2] * scene.tri_e1[tri]
            + bc[..., 2:3] * scene.tri_e2[tri])
  w0, w1, w2 = bc[..., 0:1], bc[..., 1:2], bc[..., 2:3]
  normal = em.normalize(trows.n0 * w0 + trows.n1 * w1 + trows.n2 * w2)
  tan = em.normalize(trows.t0 * w0 + trows.t1 * w1 + trows.t2 * w2)
  btn = em.normalize(trows.b0 * w0 + trows.b1 * w1 + trows.b2 * w2)
  mrows = scene.mat_table[trows.mat]
  ext_medium = mrows[:, _EXT_MEDIUM].to(torch.int32)
  exponent = collimation_to_exponent(mrows[:, _COLLIMATION])
  local = em.sample_cosine_distribution(rnd_dir, exponent)
  direction = tan * local[..., 0:1] + btn * local[..., 1:2] + normal * local[..., 2:3]
  pdf_dir = torch.clamp(em.dot(normal, direction), min=0.0) * em.kInvPi
  pdf_area = 1.0 / torch.clamp(erows.triangle_area, min=1e-12)
  is_area = erows.cls == EmitterClass.Area
  return EmissionSample(
      value=emission, origin=origin, normal=normal, direction=direction,
      pdf_sample=discrete_pdf(scene, emitter_index), pdf_area=pdf_area, pdf_dir=pdf_dir,
      pdf_dir_out=pdf_dir * pdf_area,
      is_delta=torch.zeros_like(is_area), is_distant=~is_area,
      triangle_index=erows.triangle,
      medium_index=torch.where(is_area, ext_medium, -1),
      geo_n=trows.geo_n)
