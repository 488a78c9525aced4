"""Area-emitter sampling and radiance evaluation.

Counterpart of the area-emitter parts of `etx_tracer_tpu/render/emitters.py`
(`sample_emitter_index`, `discrete_pdf`, `sample_emitter` with only the Area
class, `area_radiance`), in RGB and spectral mode: a spectral lane reads the
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

_COLLIMATION = packed.mat_column("emission_collimation")


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
