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
tracer does not). Every class renders: Mirror, Thinfilm and Boundary are
delta lobes that evaluate to zero; Void is a null lobe (the null result);
Principled is the deterministic mixture of a conductor, a dielectric and a
plastic view of the material by its metalness and transmission. Diffuse
lanes run the variations of `variations` (`config.diffuse_variations`).
The lobes that may walk (Diffuse, Plastic, Conductor, Dielectric, and
Principled's three views) get their class's lanes as their mask, and
Principled's views the lanes that pick each of them, so a walk runs on
those lanes only (`lobes.MS_BACKEND`).
"""

from __future__ import annotations

import torch

from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.core import spectrum as spmod
from etx_tracer_tpu_torch.render import images as images_mod
from etx_tracer_tpu_torch.render import spectral as spx
from etx_tracer_tpu_torch.render.bsdf import lobes
from etx_tracer_tpu_torch.scene.types import MaterialClass as MC

# random columns a sampler may consume per bounce (the JAX package's count:
# the pt_step RNG stream advances by this many draws whatever the class)
NUM_SAMPLE_RND = 7

_SAMPLERS = {MC.Translucent: lobes.translucent_sample, MC.Plastic: lobes.plastic_sample,
             MC.Conductor: lobes.conductor_sample, MC.Dielectric: lobes.dielectric_sample,
             MC.Thinfilm: lobes.thinfilm_sample, MC.Mirror: lobes.mirror_sample,
             MC.Boundary: lobes.boundary_sample, MC.Velvet: lobes.velvet_sample}
# the lobes that take their class's lanes as a walk mask
_WALK_CLASSES = frozenset({MC.Plastic, MC.Conductor, MC.Dielectric})
# delta classes (Mirror, Thinfilm, Boundary) and Void evaluate to zero and
# have no entry; Diffuse and Principled take their own arguments
_EVALUATORS = {MC.Translucent: lobes.translucent_evaluate, MC.Plastic: lobes.plastic_evaluate,
               MC.Conductor: lobes.conductor_evaluate, MC.Dielectric: lobes.dielectric_evaluate,
               MC.Velvet: lobes.velvet_evaluate}
_PDFS = {MC.Diffuse: lobes.diffuse_pdf, MC.Translucent: lobes.translucent_pdf,
         MC.Plastic: lobes.plastic_pdf, MC.Conductor: lobes.conductor_pdf,
         MC.Dielectric: lobes.dielectric_pdf, MC.Velvet: lobes.velvet_pdf}


def _select(mask: torch.Tensor, a, b):
  return type(a)(*(torch.where(mask[..., None] if x.dim() > 1 else mask, x, y)
                   for x, y in zip(a, b)))


def sample(scene, sd: lobes.ShadingData, rnd: torch.Tensor, spectral: bool = False,
           classes=(MC.Diffuse,), variations=(0,)) -> lobes.BSDFSampleR:
  """bsdf::sample over the wavefront."""
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
    if c == MC.Void:  # the null result
      continue
    m = cls == c
    if c == MC.Diffuse:
      out = lobes.diffuse_sample(scene, sd, rnd, spectral, variations, mask=m)
    elif c == MC.Principled:
      out = _principled_sample(scene, sd, rnd, spectral, mask=m)
    elif c in _WALK_CLASSES:
      out = _SAMPLERS[c](scene, sd, rnd, spectral, mask=m)
    else:
      out = _SAMPLERS[c](scene, sd, rnd, spectral)
    result = _select(m, out, result)
  return result


def evaluate(scene, sd: lobes.ShadingData, w_o: torch.Tensor, spectral: bool = False,
             classes=(MC.Diffuse,), variations=(0,)):
  """bsdf::evaluate: (bsdf_with_cos (R,C), pdf (R,))."""
  r = sd.w_i.shape[0]
  bsdf = torch.zeros((r, spx.channels(spectral)), device=sd.w_i.device)
  pdf = torch.zeros(r, device=sd.w_i.device)
  cls = sd.mat.cls
  for c in classes:
    if c != MC.Diffuse and c != MC.Principled and c not in _EVALUATORS:
      continue
    m = cls == c
    if c == MC.Diffuse:
      b, p = lobes.diffuse_evaluate(scene, sd, w_o, spectral, variations, mask=m)
    elif c == MC.Principled:
      b, p = _principled_evaluate(scene, sd, w_o, spectral, mask=m)
    elif c in _WALK_CLASSES:
      b, p = _EVALUATORS[c](scene, sd, w_o, spectral, mask=m)
    else:
      b, p = _EVALUATORS[c](scene, sd, w_o, spectral)
    bsdf = torch.where(m[..., None], b, bsdf)
    pdf = torch.where(m, p, pdf)
  return bsdf, pdf


def pdf(scene, sd: lobes.ShadingData, w_o: torch.Tensor, spectral: bool = False,
        classes=(MC.Diffuse,)):
  """The density of sampling w_o (analytic for every class: no walk runs;
  the diffuse variations all sample the cosine hemisphere)."""
  p = torch.zeros(sd.w_i.shape[0], device=sd.w_i.device)
  cls = sd.mat.cls
  for c in classes:
    if c == MC.Principled:
      p = torch.where(cls == c, _principled_pdf(scene, sd, w_o, spectral), p)
    elif c in _PDFS:
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


# ---------------------------------------------------------------------------
# Principled: the deterministic conductor / dielectric / plastic mixture
# ---------------------------------------------------------------------------


def _principled_views(sd: lobes.ShadingData):
  """(the conductor view: the material with its inner IOR's class forced to
  conductor; the dielectric and plastic view: the material itself)."""
  conductor = sd.mat.with_column("int_ior_cls", spmod.SpectralDistribution.CLASS_CONDUCTOR)
  return sd._replace(mat=conductor), sd


def _principled_factors(scene, sd: lobes.ShadingData):
  """(metalness, transmission), each times channel 0 of its image."""
  metal = images_mod.apply_scalar_image(scene, sd.mat.metalness, sd.mat, "metalness_img", sd.tex)
  trans = images_mod.apply_scalar_image(scene, sd.mat.transmission, sd.mat, "transmission_img",
                                        sd.tex)
  return metal, trans


def _principled_pdf(scene, sd, w_o, spectral):
  metal, trans = _principled_factors(scene, sd)
  sdc, sdd = _principled_views(sd)
  p_c = lobes.conductor_pdf(scene, sdc, w_o, spectral)
  p_d = lobes.dielectric_pdf(scene, sdd, w_o, spectral)
  p_p = lobes.plastic_pdf(scene, sdd, w_o, spectral)
  return p_c * metal + p_d * (1.0 - metal) * trans + p_p * (1.0 - metal) * (1.0 - trans)


def _principled_sample(scene, sd, rnd, spectral, mask=None):
  """The conductor view's sample where rnd column 5 falls below the
  metalness, else the dielectric's where column 6 falls below the
  transmission, else the plastic's; each view walks on the lanes of `mask`
  that pick it."""
  metal, trans = _principled_factors(scene, sd)
  sdc, sdd = _principled_views(sd)
  pick_metal = rnd[..., 5] < metal
  pick_trans = rnd[..., 6] < trans
  m = torch.ones_like(pick_metal) if mask is None else mask
  dielectric = m & ~pick_metal & pick_trans
  plastic = m & ~pick_metal & ~pick_trans
  non_metal = _select(pick_trans,
                      lobes.dielectric_sample(scene, sdd, rnd, spectral, mask=dielectric),
                      lobes.plastic_sample(scene, sdd, rnd, spectral, mask=plastic))
  return _select(pick_metal,
                 lobes.conductor_sample(scene, sdc, rnd, spectral, mask=m & pick_metal), non_metal)


def _principled_evaluate(scene, sd, w_o, spectral, mask=None):
  """The three views' evaluations weighted by metalness and transmission;
  each view walks on the lanes of `mask` where its weight is above 0."""
  metal, trans = _principled_factors(scene, sd)
  sdc, sdd = _principled_views(sd)
  w_c = metal
  w_d = (1.0 - metal) * trans
  w_p = (1.0 - metal) * (1.0 - trans)
  m = torch.ones_like(w_c, dtype=torch.bool) if mask is None else mask
  b_c, p_c = lobes.conductor_evaluate(scene, sdc, w_o, spectral, mask=m & (w_c > 0.0))
  b_d, p_d = lobes.dielectric_evaluate(scene, sdd, w_o, spectral, mask=m & (w_d > 0.0))
  b_p, p_p = lobes.plastic_evaluate(scene, sdd, w_o, spectral, mask=m & (w_p > 0.0))
  bsdf = b_c * w_c[..., None] + b_d * w_d[..., None] + b_p * w_p[..., None]
  return bsdf, p_c * w_c + p_d * w_d + p_p * w_p
