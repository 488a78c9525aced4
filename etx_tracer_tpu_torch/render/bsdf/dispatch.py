"""Masked BSDF dispatch over material classes.

Counterpart of `etx_tracer_tpu/render/bsdf/dispatch.py`'s masked dispatch
(`_sample_masked`, `_evaluate_masked`, `pdf`, `reverse_pdf`), which is what the JAX
package runs (its material-sorted variants are switched off). Every lobe
whose class is in the scene's `config.material_classes` runs on the whole
wavefront and results are selected by class masks; lanes of no listed class
keep the null result (delta, zero weight). The JAX package wraps each
costly class in `lax.cond` to skip a bounce with no lane of it; the result
is the same either way, and here every listed class simply runs, unless
the caller narrows the dispatch with `restrict` to the lanes whose results
it reads and the classes they hold (the VCM integrator does; the path
tracer does not). The port has the Diffuse, Conductor, Dielectric,
Thinfilm and Boundary classes; Thinfilm and Boundary are delta lobes that
evaluate to zero.
"""

from __future__ import annotations

import torch

from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.render import spectral as spx
from etx_tracer_tpu_torch.render.bsdf import lobes
from etx_tracer_tpu_torch.scene.types import MaterialClass as MC

# random columns a sampler may consume per bounce (the JAX package's count:
# the pt_step RNG stream advances by this many draws whatever the class)
NUM_SAMPLE_RND = 7

_SAMPLERS = {MC.Diffuse: lobes.diffuse_sample, MC.Conductor: lobes.conductor_sample,
             MC.Dielectric: lobes.dielectric_sample, MC.Thinfilm: lobes.thinfilm_sample,
             MC.Boundary: lobes.boundary_sample}
# delta classes (Thinfilm, Boundary) evaluate to zero and have no entry
_EVALUATORS = {MC.Diffuse: lobes.diffuse_evaluate, MC.Conductor: lobes.conductor_evaluate,
               MC.Dielectric: lobes.dielectric_evaluate}
_PDFS = {MC.Diffuse: lobes.diffuse_pdf, MC.Conductor: lobes.conductor_pdf,
         MC.Dielectric: lobes.dielectric_pdf}


def _check_classes(classes):
  missing = [c for c in classes if c not in _SAMPLERS]
  if missing:
    raise NotImplementedError(
        f"material classes {missing}: the slice that brings the remaining BSDFs")


def _select(mask: torch.Tensor, a, b):
  return type(a)(*(torch.where(mask[..., None] if x.dim() > 1 else mask, x, y)
                   for x, y in zip(a, b)))


def sample(scene, sd: lobes.ShadingData, rnd: torch.Tensor, spectral: bool = False,
           classes=(MC.Diffuse,)) -> lobes.BSDFSampleR:
  """bsdf::sample over the wavefront."""
  _check_classes(classes)
  r = sd.w_i.shape[0]
  dev = sd.w_i.device
  result = lobes.BSDFSampleR(
      w_o=sd.w_i, weight=torch.zeros((r, spx.channels(spectral)), device=dev),
      pdf=torch.zeros(r, device=dev), eta=torch.ones(r, device=dev),
      is_delta=torch.ones(r, dtype=torch.bool, device=dev),
      is_diffuse=torch.zeros(r, dtype=torch.bool, device=dev),
      is_reflection=torch.zeros(r, dtype=torch.bool, device=dev), medium=sd.medium)
  cls = sd.mat.cls
  for c in classes:
    result = _select(cls == c, _SAMPLERS[c](scene, sd, rnd, spectral), result)
  return result


def evaluate(scene, sd: lobes.ShadingData, w_o: torch.Tensor, spectral: bool = False,
             classes=(MC.Diffuse,)):
  """bsdf::evaluate: (bsdf_with_cos (R,C), pdf (R,))."""
  _check_classes(classes)
  r = sd.w_i.shape[0]
  bsdf = torch.zeros((r, spx.channels(spectral)), device=sd.w_i.device)
  pdf = torch.zeros(r, device=sd.w_i.device)
  cls = sd.mat.cls
  for c in classes:
    if c not in _EVALUATORS:
      continue
    m = cls == c
    b, p = _EVALUATORS[c](scene, sd, w_o, spectral)
    bsdf = torch.where(m[..., None], b, bsdf)
    pdf = torch.where(m, p, pdf)
  return bsdf, pdf


def pdf(scene, sd: lobes.ShadingData, w_o: torch.Tensor, spectral: bool = False,
        classes=(MC.Diffuse,)):
  _check_classes(classes)
  p = torch.zeros(sd.w_i.shape[0], device=sd.w_i.device)
  cls = sd.mat.cls
  for c in classes:
    if c in _PDFS:
      p = torch.where(cls == c, _PDFS[c](scene, sd, w_o, spectral), p)
  return p


def reverse_pdf(scene, sd: lobes.ShadingData, w_o: torch.Tensor, spectral: bool = False,
                classes=(MC.Diffuse,)):
  """The pdf of sampling the reverse direction: -w_i from incident -w_o."""
  return pdf(scene, sd._replace(w_i=-w_o), -sd.w_i, spectral, classes)


def restrict(sd: lobes.ShadingData, lanes: torch.Tensor, classes):
  """A dispatch over the lanes whose results are read: (`sd` with no class,
  -1, outside `lanes`; the classes of `classes` that the lanes of `lanes`
  hold, found by one host read). A dispatch of the pair gives each lane of
  `lanes` what a dispatch of (`sd`, `classes`) gives it, and the null
  result elsewhere, without running the lobes that no such lane needs (a
  smooth Dielectric's evaluate and pdf, say, which run on every lane of a
  listed class whatever its roughness)."""
  cls = torch.where(lanes, sd.mat.cls, -1)
  wanted = torch.tensor([int(c) for c in classes], dtype=cls.dtype, device=cls.device)
  held = (cls[:, None] == wanted).any(dim=0).tolist()
  rows = sd.mat._rows
  mat = type(sd.mat)(torch.cat([cls.to(rows.dtype)[:, None], rows[:, 1:]], dim=1))
  return sd._replace(mat=mat), tuple(c for c, h in zip(classes, held) if h)


def is_delta(sd: lobes.ShadingData) -> torch.Tensor:
  """Whether each lane's material is a delta lobe."""
  rough_max = torch.maximum(sd.mat.roughness[..., 0], sd.mat.roughness[..., 1])
  cls = sd.mat.cls
  always = (cls == MC.Mirror) | (cls == MC.Thinfilm) | (cls == MC.Void)
  rough_classes = (cls == MC.Conductor) | (cls == MC.Dielectric)
  return always | (rough_classes & (rough_max <= lobes.kDeltaAlpha))


def fix_shading_normal(geo_n, sh_n, w_i, w_o):
  """Light-transport shading-normal correction."""
  w_i_g = em.dot(w_i, geo_n)
  w_i_s = em.dot(w_i, sh_n)
  w_o_g = em.dot(w_o, geo_n)
  w_o_s = em.dot(w_o, sh_n)
  den = torch.clamp(torch.abs(w_o_s * w_i_g), min=em.kInvMaxHalf)
  return torch.abs(w_o_g * w_i_s) / den


def albedo(scene, sd: lobes.ShadingData, spectral: bool = False) -> torch.Tensor:
  """bsdf::albedo: the scattering colour (conductor and mirror: reflectance)."""
  scat = spx.query_spd(scene, sd.mat.scattering_spec, sd.wl, spectral)
  refl = spx.query_spd(scene, sd.mat.reflectance_spec, sd.wl, spectral)
  use_refl = (sd.mat.cls == MC.Conductor) | (sd.mat.cls == MC.Mirror)
  return torch.where(use_refl[..., None], refl, scat)
