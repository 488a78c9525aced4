"""Vectorized BSDF lobes: Diffuse (Lambert, the Heitz rough-diffuse walk,
the vMF rough diffuse), Translucent, Plastic, Conductor, Dielectric,
Thinfilm, Mirror, Boundary and Velvet.

Counterpart of `etx_tracer_tpu/render/bsdf/lobes.py`. The module switch
`MS_BACKEND` picks the multiple-scattering backend of the rough conductor,
dielectric and plastic lobes, as in the JAX package: "lut" (the default)
takes the energy-compensation tables of `energy_lut.py`, "walk" the Heitz
random walks of `multiscatter.py`, stochastic and reference-faithful; the
pdfs are the analytic ones under either. A walking lobe walks only the
lanes of its `mask` (those whose result the caller reads; `dispatch`
passes each class's lanes), so a bounce with none of them runs no trip.
Conventions as there: `w_i` points TOWARD the surface; the normal frame is
flipped so the incident ray arrives from local +z (`entering` records the
flip);
responses are (R, C) tensors, C = 1 spectral, C = 3 RGB. Smooth conductors
and dielectrics (roughness <= 1e-4) take exact delta forms. Colours,
roughness and (in `dispatch`) Principled's metalness and transmission read
the material's images where a material has them (`render/images.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.core import rng
from etx_tracer_tpu_torch.core import spectrum as spmod
from etx_tracer_tpu_torch.render import images as images_mod
from etx_tracer_tpu_torch.render import spectral as spx
from etx_tracer_tpu_torch.render.bsdf import common as mf
from etx_tracer_tpu_torch.render.bsdf import energy_lut
from etx_tracer_tpu_torch.render.bsdf import multiscatter as ms

kDeltaAlpha = em.kDeltaAlphaThreshold

# The multiple-scattering backend of the rough conductor, dielectric and
# plastic lobes: "lut" (energy-compensation tables, no loop) or "walk" (the
# Heitz walks, one host read a trip).
MS_BACKEND = "lut"

# RGB mode evaluates a thin film at one wavelength per channel, jittered in
# the channel's band
_TF_RGB_BASE = (610.0, 537.0, 450.0)
_TF_RGB_SPAN = (45.0, 47.0, 23.5)


class ShadingData(NamedTuple):
  """Per-ray shading inputs."""
  w_i: torch.Tensor     # (R,3) incident direction, toward the surface
  nrm: torch.Tensor     # (R,3) shading normal (unflipped)
  tan: torch.Tensor     # (R,3)
  btn: torch.Tensor     # (R,3)
  geo_n: torch.Tensor   # (R,3)
  tex: torch.Tensor     # (R,2)
  wl: torch.Tensor      # (R,) wavelength (spectral mode)
  medium: torch.Tensor  # (R,) int32 current medium
  mat: object           # packed.MaterialRows gathered per ray


class BSDFSampleR(NamedTuple):
  w_o: torch.Tensor        # (R,3)
  weight: torch.Tensor     # (R,C) bsdf*cos/pdf
  pdf: torch.Tensor        # (R,)
  eta: torch.Tensor        # (R,)
  is_delta: torch.Tensor   # (R,) bool
  is_diffuse: torch.Tensor  # (R,) bool
  is_reflection: torch.Tensor  # (R,) bool
  medium: torch.Tensor     # (R,) int32 medium after the event


def entering(sd: ShadingData) -> torch.Tensor:
  return em.dot(sd.nrm, sd.w_i) < 0.0


def normal_frame(sd: ShadingData):
  """Flipped frame rows (tan, btn, nrm) and the entering flag."""
  ent = entering(sd)
  s = torch.where(ent, 1.0, -1.0)[..., None]
  return (sd.tan * s, sd.btn * s, sd.nrm * s), ent


def _flags(r: int, dev, delta, diffuse, reflection):
  """(is_delta, is_diffuse, is_reflection): a bool or an (R,) tensor each."""
  def full(x):
    return x if isinstance(x, torch.Tensor) else torch.full((r,), x, dtype=torch.bool,
                                                               device=dev)
  return full(delta), full(diffuse), full(reflection)


def _scattering(scene, sd: ShadingData, spectral: bool) -> torch.Tensor:
  """The scattering colour: its spectrum times its image's RGB."""
  v = spx.query_spd(scene, sd.mat.scattering_spec, sd.wl, spectral)
  return images_mod.apply_rgb_image(scene, v, sd.mat, "scattering_img", sd.tex, sd.wl, spectral)


def _reflectance(scene, sd: ShadingData, spectral: bool) -> torch.Tensor:
  """The reflectance colour: its spectrum times its image's RGB."""
  v = spx.query_spd(scene, sd.mat.reflectance_spec, sd.wl, spectral)
  return images_mod.apply_rgb_image(scene, v, sd.mat, "reflectance_img", sd.tex, sd.wl,
                                    spectral)


def _ior(scene, sd, eta_idx, k_idx, spectral):
  eta = spx.query_spd(scene, eta_idx, sd.wl, spectral)
  eta = torch.where((eta_idx >= 0)[..., None], eta, 1.0)
  k = spx.query_spd(scene, k_idx, sd.wl, spectral)
  return eta, k


def _fresnel_at(scene, sd, cos_theta, spectral, swap=None):
  """The material's Fresnel term at cos_theta: complex ext/int IORs, the
  conductor's RGB conversion, and thin-film interference where the
  material has a film. swap: optional (R,) bool, swap the int and ext IORs
  (exiting a dielectric)."""
  ext_eta, ext_k = _ior(scene, sd, sd.mat.ext_ior_eta, sd.mat.ext_ior_k, spectral)
  int_eta, int_k = _ior(scene, sd, sd.mat.int_ior_eta, sd.mat.int_ior_k, spectral)
  if swap is not None:
    sw = swap[..., None]
    ext_eta, int_eta = torch.where(sw, int_eta, ext_eta), torch.where(sw, ext_eta, int_eta)
    ext_k, int_k = torch.where(sw, int_k, ext_k), torch.where(sw, ext_k, int_k)
  is_cond = sd.mat.int_ior_cls == spmod.SpectralDistribution.CLASS_CONDUCTOR
  if "thinfilm" not in scene.material_features:
    # no material has a film: the plain Fresnel term (what the film's
    # `where` selects on every such lane)
    return mf.fresnel(cos_theta, ext_eta, ext_k, int_eta, int_k, spectral,
                      int_is_conductor=is_cond)
  tf_eta, tf_k = _ior(scene, sd, sd.mat.thinfilm_eta, sd.mat.thinfilm_k, spectral)
  tf_thick = 0.5 * (sd.mat.thinfilm_min + sd.mat.thinfilm_max)
  tf_active = (sd.mat.thinfilm_min * sd.mat.thinfilm_max) > 0.0
  tf_thick = torch.where(tf_active, tf_thick, 0.0)
  if spectral:
    tf_wl = sd.wl[..., None]
  else:
    # one wavelength per channel, jittered inside the channel's band by a
    # draw seeded from the ray's bits (fixed per lane, new per sample)
    ba = (sd.w_i[..., 0] + sd.tex[..., 0]).contiguous().view(torch.int32)
    bb = (sd.w_i[..., 1] + sd.tex[..., 1]).contiguous().view(torch.int32)
    _, j3 = rng.next_n(rng.seed(ba, bb), 3)
    tf_wl = (em.constant(_TF_RGB_BASE, j3.device)
             + em.constant(_TF_RGB_SPAN, j3.device) * (2.0 * j3 - 1.0))
  return mf.fresnel(cos_theta, ext_eta, ext_k, int_eta, int_k, spectral,
                    int_is_conductor=is_cond, tf_thickness=tf_thick,
                    tf_eta=tf_eta, tf_k=tf_k, tf_wavelengths=tf_wl)


def _eta_ratio(scene, sd, spectral):
  """Monochromatic int/ext eta ratio (dielectric refraction)."""
  ext_eta, _ = _ior(scene, sd, sd.mat.ext_ior_eta, sd.mat.ext_ior_k, spectral)
  int_eta, _ = _ior(scene, sd, sd.mat.int_ior_eta, sd.mat.int_ior_k, spectral)
  return (spx.monochromatic(int_eta, spectral)
          / torch.clamp(spx.monochromatic(ext_eta, spectral), min=1e-6))


def _roughness(sd, scene) -> torch.Tensor:
  """(R,2) roughness, times channel 0 of its image."""
  r = torch.stack([sd.mat.roughness[..., 0], sd.mat.roughness[..., 1]], dim=-1)
  return images_mod.apply_scalar_image(scene, r, sd.mat, "roughness_img", sd.tex)


def _is_delta_alpha(alpha) -> torch.Tensor:
  return torch.maximum(alpha[..., 0], alpha[..., 1]) <= kDeltaAlpha


def _local_w_i(frame, sd, min_z=1e-4):
  """-w_i in the flipped frame with z held at or above min_z."""
  w = em.to_local(*frame, -sd.w_i)
  return torch.cat([w[..., :2], torch.clamp(w[..., 2:3], min=min_z)], dim=-1)


def _up(like: torch.Tensor) -> torch.Tensor:
  return em.constant((0.0, 0.0, 1.0), like.device).expand(like.shape)


def _crossing_medium(sd, ent):
  return torch.where(ent, sd.mat.int_medium, sd.mat.ext_medium)


# ---------------------------------------------------------------------------
# Boundary: a medium interface
# ---------------------------------------------------------------------------


def boundary_sample(scene, sd: ShadingData, rnd: torch.Tensor, spectral: bool = False) -> BSDFSampleR:
  """Pass straight through with unit weight into the medium on the far side
  (a delta lobe; it evaluates to zero)."""
  r = sd.w_i.shape[0]
  dev = sd.w_i.device
  return BSDFSampleR(sd.w_i, torch.ones((r, spx.channels(spectral)), device=dev),
                     torch.ones(r, device=dev), torch.ones(r, device=dev),
                     *_flags(r, dev, True, False, False), _crossing_medium(sd, entering(sd)))


# ---------------------------------------------------------------------------
# Diffuse: Lambert (variation 0), the Heitz rough-diffuse walk (1), the vMF
# rough diffuse (2)
# ---------------------------------------------------------------------------


def _rough_diffuse_frame(scene, sd, frame):
  """(-w_i in the flipped frame with z held at or above 1e-4, renormalised;
  the clamped roughness) for the rough-diffuse variations."""
  return em.normalize(_local_w_i(frame, sd)), mf.clamp_alpha(_roughness(sd, scene))


def diffuse_sample(scene, sd: ShadingData, rnd: torch.Tensor, spectral: bool = False,
                   variations=(0,), mask=None) -> BSDFSampleR:
  """A cosine-weighted hemisphere sample; lanes of variation 1 take the
  walk's direction and energy instead (the walk runs on the lanes of
  `mask`, those whose result the caller reads), lanes of variation 2 the
  vMF BRDF's weight. `variations`: the variations present."""
  frame, _ = normal_frame(sd)
  local_w_o = em.sample_cosine_distribution(rnd[..., 0:2], 1.0)
  albedo = _scattering(scene, sd, spectral)
  weight = albedo
  pdf = em.kInvPi * local_w_o[..., 2]
  if 1 in variations or 2 in variations:
    w_i_l, alpha = _rough_diffuse_frame(scene, sd, frame)
    if 1 in variations:
      m1 = sd.mat.diffuse_variation == 1
      wo1, e1, _ = ms.diffuse_sample_walk(w_i_l, alpha, albedo, rnd,
                                          active0=m1 if mask is None else m1 & mask)
      local_w_o = torch.where(m1[..., None], wo1, local_w_o)
      weight = torch.where(m1[..., None], e1, weight)
      pdf = torch.where(m1, em.kInvPi * torch.clamp(local_w_o[..., 2], min=0.0), pdf)
    if 2 in variations:
      # bsdf * cos / pdf = f * cos / (cos / pi) = f * pi
      f2 = ms.vmf_diffuse_brdf(w_i_l, local_w_o, alpha, albedo)
      weight = torch.where((sd.mat.diffuse_variation == 2)[..., None], f2 * em.kPi, weight)
  w_o = em.from_local(*frame, local_w_o)
  r = sd.w_i.shape[0]
  dev = sd.w_i.device
  return BSDFSampleR(w_o, weight, pdf, torch.ones(r, device=dev),
                     *_flags(r, dev, False, True, True), sd.medium)


def diffuse_evaluate(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False,
                     variations=(0,), mask=None):
  """(bsdf * cos (R,C), pdf (R,)) toward w_o: Lambert, the walk's estimate
  (variation 1, walked on the lanes of `mask`, its stream seeded from the
  bits of w_o + uv) or the vMF BRDF (variation 2); the pdf is the cosine
  hemisphere's for every variation."""
  frame, _ = normal_frame(sd)
  cos_o = em.dot(frame[2], w_o)
  albedo = _scattering(scene, sd, spectral)
  valid = cos_o > em.kEpsilon
  bsdf = albedo * em.kInvPi * torch.clamp(cos_o, min=0.0)[..., None]
  if 1 in variations or 2 in variations:
    w_i_l, alpha = _rough_diffuse_frame(scene, sd, frame)
    w_o_l = em.to_local(*frame, w_o)
    if 1 in variations:
      m1 = sd.mat.diffuse_variation == 1
      v1, _ = ms.diffuse_eval_walk(w_i_l, w_o_l, alpha, albedo, w_o[..., 0] + sd.tex[..., 0],
                                   w_o[..., 1] + sd.tex[..., 1],
                                   active0=m1 if mask is None else m1 & mask)
      bsdf = torch.where(m1[..., None], v1, bsdf)
    if 2 in variations:
      f2 = ms.vmf_diffuse_brdf(w_i_l, w_o_l, alpha, albedo)
      bsdf = torch.where((sd.mat.diffuse_variation == 2)[..., None],
                         f2 * torch.clamp(cos_o, min=0.0)[..., None], bsdf)
  pdf = em.kInvPi * torch.clamp(cos_o, min=0.0)
  return torch.where(valid[..., None], bsdf, 0.0), torch.where(valid, pdf, 0.0)


def diffuse_pdf(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False) -> torch.Tensor:
  """The cosine hemisphere's density (every variation samples it)."""
  (_, _, nrm), _ = normal_frame(sd)
  return torch.clamp(em.dot(nrm, w_o), min=0.0) * em.kInvPi


# ---------------------------------------------------------------------------
# Translucent: diffuse reflection and diffuse transmission
# ---------------------------------------------------------------------------


def translucent_sample(scene, sd: ShadingData, rnd: torch.Tensor,
                       spectral: bool = False) -> BSDFSampleR:
  """A cosine-weighted direction on the reflected side (weight: the
  reflectance) or the transmitted one (the scattering colour, into the
  medium across), picked by their monochromatic shares."""
  frame, ent = normal_frame(sd)
  tr = _scattering(scene, sd, spectral)
  rf = _reflectance(scene, sd, spectral)
  tr_v = spx.monochromatic(tr, spectral)
  rf_v = spx.monochromatic(rf, spectral)
  total = tr_v + rf_v
  p_tr = torch.where(total > 0, tr_v / torch.clamp(total, min=1e-20), 0.0)
  pick_tr = rnd[..., 2] < p_tr
  local_w_o = em.sample_cosine_distribution(rnd[..., 0:2], 1.0)
  w_up = em.from_local(*frame, local_w_o)
  n_dot_o = torch.abs(local_w_o[..., 2])
  w_o = torch.where(pick_tr[..., None], -w_up, w_up)
  pdf = n_dot_o * em.kInvPi * torch.where(pick_tr, p_tr, 1.0 - p_tr)
  weight = torch.where(pick_tr[..., None], tr, rf)
  medium = torch.where(pick_tr, _crossing_medium(sd, ent), sd.medium)
  r = sd.w_i.shape[0]
  dev = sd.w_i.device
  return BSDFSampleR(w_o, weight, torch.where(total > 0, pdf, 0.0), torch.ones(r, device=dev),
                     *_flags(r, dev, False, True, ~pick_tr), medium)


def translucent_evaluate(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False):
  n = sd.nrm
  n_dot_i = -em.dot(n, sd.w_i)
  n_dot_o = em.dot(n, w_o)
  reflection = n_dot_o * n_dot_i > 0.0
  tr = _scattering(scene, sd, spectral)
  rf = _reflectance(scene, sd, spectral)
  tr_v = spx.monochromatic(tr, spectral)
  rf_v = spx.monochromatic(rf, spectral)
  total = tr_v + rf_v
  scale = torch.where(total > 1.0, 1.0 / torch.clamp(total, min=1e-20), 1.0)
  a_o = torch.abs(n_dot_o)
  func = torch.where(reflection[..., None], rf, tr) * (scale * em.kInvPi)[..., None]
  bsdf = func * a_o[..., None]
  sel = torch.where(reflection, rf_v, tr_v) / torch.clamp(total, min=1e-20)
  pdf = em.kInvPi * a_o * sel
  ok = total > 0
  return torch.where(ok[..., None], bsdf, 0.0), torch.where(ok, pdf, 0.0)


def translucent_pdf(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False):
  return translucent_evaluate(scene, sd, w_o, spectral)[1]


# ---------------------------------------------------------------------------
# Mirror: delta reflection
# ---------------------------------------------------------------------------


def mirror_sample(scene, sd: ShadingData, rnd: torch.Tensor, spectral: bool = False) -> BSDFSampleR:
  frame, _ = normal_frame(sd)
  w_o = em.normalize(em.reflect(sd.w_i, frame[2]))
  r = sd.w_i.shape[0]
  dev = sd.w_i.device
  return BSDFSampleR(w_o, _scattering(scene, sd, spectral), torch.ones(r, device=dev),
                     torch.ones(r, device=dev), *_flags(r, dev, True, False, True), sd.medium)


# ---------------------------------------------------------------------------
# Conductor: exact delta reflection when smooth, the energy-compensated LUT
# lobe (or the Heitz walk) when rough
# ---------------------------------------------------------------------------


def conductor_sample(scene, sd: ShadingData, rnd: torch.Tensor, spectral: bool = False,
                     mask=None) -> BSDFSampleR:
  frame, _ = normal_frame(sd)
  alpha = _roughness(sd, scene)
  delta = _is_delta_alpha(alpha)
  alpha_c = mf.clamp_alpha(alpha)
  w_i_l = em.normalize(_local_w_i(frame, sd))

  def fres(cos_t):
    return _fresnel_at(scene, sd, cos_t, spectral)

  pdf_rough = None
  if MS_BACKEND == "lut":
    w_o_ms, energy, pdf_rough = energy_lut.conductor_sample_lut(fres, w_i_l, alpha_c, rnd)
  else:
    w_o_ms, energy, _ = ms.conductor_sample_walk(fres, w_i_l, alpha_c, rnd,
                                                 active0=~delta if mask is None else mask & ~delta)
  refl = _reflectance(scene, sd, spectral)

  # delta lanes: mirror reflection with the Fresnel term at the incident cosine
  w_o_delta = em.reflect(-w_i_l, _up(w_i_l))
  f_delta = fres(w_i_l[..., 2])

  w_o_l = torch.where(delta[..., None], w_o_delta, w_o_ms)
  weight = refl * torch.where(delta[..., None], f_delta, energy)
  ok = w_o_l[..., 2] > em.kEpsilon
  weight = torch.where(ok[..., None], weight, 0.0)
  if pdf_rough is None:
    # the walk's density: D / ((1 + Lambda) 4 cos_i) + cos_o
    pdf_rough = mf.ms_pdf(w_i_l, w_o_l, alpha_c)
  pdf = torch.where(ok, torch.where(delta, 1.0, pdf_rough), 0.0)

  w_o = em.from_local(*frame, w_o_l)
  r = sd.w_i.shape[0]
  dev = sd.w_i.device
  return BSDFSampleR(em.normalize(w_o), weight, pdf, torch.ones(r, device=dev),
                     *_flags(r, dev, delta, False, True), sd.medium)


def conductor_evaluate(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False,
                       mask=None):
  """The energy-compensated closed form, or the walk's estimate (its stream
  seeded from the bits of w_o + uv, walked on the lanes of `mask`); zero
  on delta lanes. The pdf is the sampling density of the backend."""
  frame, _ = normal_frame(sd)
  alpha = _roughness(sd, scene)
  alpha_c = mf.clamp_alpha(alpha)
  w_i_l = em.to_local(*frame, -sd.w_i)
  w_o_l = em.to_local(*frame, w_o)
  ok = (w_i_l[..., 2] > em.kEpsilon) & (w_o_l[..., 2] > em.kEpsilon) & ~_is_delta_alpha(alpha)

  def fres(cos_t):
    return _fresnel_at(scene, sd, cos_t, spectral)

  if MS_BACKEND == "lut":
    value = energy_lut.conductor_eval_lut(fres, w_i_l, w_o_l, alpha_c)
    pdf = energy_lut.conductor_pdf_lut(w_i_l, w_o_l, alpha_c)
  else:
    value, _ = ms.conductor_eval_walk(fres, w_i_l, w_o_l, alpha_c, w_o[..., 0] + sd.tex[..., 0],
                                      w_o[..., 1] + sd.tex[..., 1],
                                      active0=ok if mask is None else ok & mask)
    pdf = mf.ms_pdf(w_i_l, w_o_l, alpha_c)
  bsdf = _reflectance(scene, sd, spectral) * value
  return torch.where(ok[..., None], bsdf, 0.0), torch.where(ok, pdf, 0.0)


def conductor_pdf(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False) -> torch.Tensor:
  frame, _ = normal_frame(sd)
  alpha = _roughness(sd, scene)
  w_i_l = em.to_local(*frame, -sd.w_i)
  w_o_l = em.to_local(*frame, w_o)
  ok = (w_i_l[..., 2] > em.kEpsilon) & (w_o_l[..., 2] > em.kEpsilon) & ~_is_delta_alpha(alpha)
  if MS_BACKEND == "lut":
    pdf = energy_lut.conductor_pdf_lut(w_i_l, w_o_l, mf.clamp_alpha(alpha))
  else:
    pdf = mf.ms_pdf(w_i_l, w_o_l, mf.clamp_alpha(alpha))
  return torch.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# Dielectric: exact delta reflect/refract when smooth; rough lanes take the
# single-scatter VNDF sample scaled by the 1/E_d compensation, or the walk
# ---------------------------------------------------------------------------


def _crossing_eta(scene, sd, ent, spectral):
  """eta of this crossing: the far side's over the near side's."""
  eta_io = _eta_ratio(scene, sd, spectral)
  return torch.where(ent, eta_io, 1.0 / torch.clamp(eta_io, min=1e-6))


def _half_vector(w_i_l, w_o_l, eta):
  """The microfacet normal of a reflection or refraction, on the +z side."""
  reflection = w_o_l[..., 2] > 0.0
  m_r = em.normalize(w_i_l + w_o_l)
  m_t = em.normalize(w_i_l + w_o_l * eta[..., None])
  m = torch.where(reflection[..., None], m_r, m_t)
  return m * torch.where(m[..., 2] >= 0.0, 1.0, -1.0)[..., None], reflection


def _dielectric_pdf_ref(scene, sd, w_i_l, w_o_l, ent, eta, alpha_c, spectral):
  """The dielectric density in the flipped frame: visible-NDF probability x
  Fresnel selection x |dwh/dwo| + |cos_o|."""
  m, reflection = _half_vector(w_i_l, w_o_l, eta)
  om = em.dot(w_o_l, m)
  im = em.dot(w_i_l, m)
  dwh_r = 1.0 / torch.clamp(4.0 * torch.abs(om), min=1e-9)
  sqrt_denom = im + eta * om
  dwh_t = em.sqr(eta) * torch.abs(om) / torch.clamp(em.sqr(sqrt_denom), min=1e-12)
  dwh = torch.where(reflection, dwh_r, dwh_t)
  d = mf.ggx_d(m, alpha_c)
  lam_i = mf.smith_lambda(w_i_l, alpha_c)
  prob = torch.clamp(im * d / torch.clamp(
      (1.0 + lam_i) * torch.clamp(w_i_l[..., 2], min=1e-6), min=1e-9), min=0.0)
  f = spx.monochromatic(_fresnel_at(scene, sd, im, spectral, swap=~ent), spectral)
  prob = prob * torch.where(reflection, f, 1.0 - f)
  return torch.abs(prob * dwh) + torch.abs(w_o_l[..., 2])


def _walk_fresnel(scene, sd, ent, spectral):
  """The walks' Fresnel closures: (fresnel(cos, outside) on the side the
  walk is on, monochromatic(response))."""
  def fres_walk(cos_t, outside):
    return _fresnel_at(scene, sd, cos_t, spectral, swap=torch.logical_xor(ent, outside))

  def mono(v):
    return spx.monochromatic(v, spectral)

  return fres_walk, mono


def dielectric_sample(scene, sd: ShadingData, rnd: torch.Tensor, spectral: bool = False,
                      mask=None) -> BSDFSampleR:
  frame, ent = normal_frame(sd)
  alpha = _roughness(sd, scene)
  delta = _is_delta_alpha(alpha)
  alpha_c = mf.clamp_alpha(alpha)
  w_i_l = _local_w_i(frame, sd)
  eta = _crossing_eta(scene, sd, ent, spectral)

  m = mf.sample_vndf(rnd[..., 0:2], w_i_l, alpha_c)
  m = torch.where(delta[..., None], _up(m), m)

  cos_im = em.dot(w_i_l, m)
  f = _fresnel_at(scene, sd, cos_im, spectral, swap=~ent)
  f_mono = spx.monochromatic(f, spectral)
  pick_reflect = rnd[..., 2] < f_mono

  w_r = em.reflect(-w_i_l, m)
  # refraction through m with the relative eta
  inv_eta = 1.0 / torch.clamp(eta, min=1e-6)
  c = cos_im
  sin2_t = (1.0 - c * c) * em.sqr(inv_eta)
  tir = sin2_t >= 1.0
  cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
  w_t = em.normalize((-w_i_l) * inv_eta[..., None] + (inv_eta * c - cos_t)[..., None] * m)

  pick_reflect = pick_reflect | tir
  w_o_l = torch.where(pick_reflect[..., None], w_r, w_t)

  refl = _reflectance(scene, sd, spectral)
  scat = _scattering(scene, sd, spectral)

  g1 = mf.ggx_g1(w_i_l, m, alpha_c)
  g2_r = g1 * mf.ggx_g1(w_r, m, alpha_c)
  g2_t = g1 * mf.ggx_g1(torch.cat([w_t[..., :2], -w_t[..., 2:3]], dim=-1), m, alpha_c)

  # radiance transport factor for refraction (camera paths): 1/eta^2
  factor = em.sqr(inv_eta)
  p_sel = torch.where(pick_reflect, torch.where(tir, 1.0, f_mono), 1.0 - f_mono)

  g1_safe = torch.clamp(g1, min=1e-9)
  shadow_r = torch.where(delta, 1.0, g2_r / g1_safe)[..., None]
  shadow_t = torch.where(delta, 1.0, g2_t / g1_safe)[..., None]
  w_refl = refl * (f / torch.clamp(f_mono, min=1e-9)[..., None]) * shadow_r
  w_tran = (scat * ((1.0 - f) / torch.clamp(1.0 - f_mono, min=1e-9)[..., None])
            * factor[..., None] * shadow_t)
  w_refl_tir = refl * shadow_r
  weight = torch.where(pick_reflect[..., None], torch.where(tir[..., None], w_refl_tir, w_refl),
                       w_tran)

  ok = torch.where(pick_reflect, w_o_l[..., 2] > 0.0, w_o_l[..., 2] < 0.0)
  weight = torch.where(ok[..., None], weight, 0.0)

  if MS_BACKEND == "lut":
    # rough lanes keep the single-scatter sample (its weight g2/g1 is
    # f_ss / p) and gain the lost multiple-scatter energy through the same
    # 1/E_d(mu_i) compensation the evaluation applies
    a_iso = torch.sqrt(alpha_c[..., 0] * alpha_c[..., 1])
    comp = energy_lut.dielectric_compensation(w_i_l[..., 2], a_iso, eta)
    weight = torch.where(delta[..., None], weight, weight * comp[..., None])
  else:
    # rough lanes: the walk's direction, side and energy replace the
    # single-scatter sample
    fres_walk, mono = _walk_fresnel(scene, sd, ent, spectral)
    wo_walk, e_walk, out_walk, escaped, _ = ms.dielectric_sample_walk(
        fres_walk, mono, eta, w_i_l, alpha_c, rnd,
        active0=~delta if mask is None else mask & ~delta)
    e_mono = mono(e_walk)
    tint = e_walk / torch.clamp(e_mono, min=1e-9)[..., None]
    factor_w = em.sqr(1.0 / torch.clamp(eta, min=1e-6))
    w_walk = tint * torch.where(out_walk[..., None], refl, scat * factor_w[..., None])
    w_walk = torch.where((escaped & (e_mono > 0.0))[..., None], w_walk, 0.0)
    rough = ~delta
    pick_reflect = torch.where(rough, out_walk, pick_reflect)
    w_o_l = torch.where(rough[..., None], wo_walk, w_o_l)
    weight = torch.where(rough[..., None], w_walk, weight)
    ok = torch.where(rough, escaped & (torch.abs(wo_walk[..., 2]) > em.kEpsilon), ok)
    weight = torch.where(ok[..., None], weight, 0.0)

  pdf_rough = _dielectric_pdf_ref(scene, sd, w_i_l, w_o_l, ent, eta, alpha_c, spectral)
  pdf = torch.where(ok, torch.where(delta, p_sel, pdf_rough), 0.0)

  w_o = em.normalize(em.from_local(*frame, w_o_l))
  medium = torch.where(pick_reflect, sd.medium, _crossing_medium(sd, ent))
  out_eta = torch.where(pick_reflect, 1.0, eta)
  r = sd.w_i.shape[0]
  return BSDFSampleR(w_o, weight, pdf, out_eta,
                     *_flags(r, sd.w_i.device, delta, False, pick_reflect), medium)


def dielectric_evaluate(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False,
                        mask=None):
  """Rough dielectric: the analytic single-scatter Walter terms scaled by
  the 1/E_d compensation, or twice the walk's estimate times |cos_o| (its
  stream seeded from the bits of w_o + uv, walked on the lanes of `mask`);
  zero on delta lanes."""
  frame, ent = normal_frame(sd)
  alpha = _roughness(sd, scene)
  delta = _is_delta_alpha(alpha)
  alpha_c = mf.clamp_alpha(alpha)
  w_i_l = em.to_local(*frame, -sd.w_i)
  w_o_l = em.to_local(*frame, w_o)
  cos_i = w_i_l[..., 2]
  cos_o = w_o_l[..., 2]
  eta = _crossing_eta(scene, sd, ent, spectral)
  m, reflection = _half_vector(w_i_l, w_o_l, eta)
  refl_alb = _reflectance(scene, sd, spectral)
  scat_alb = _scattering(scene, sd, spectral)

  if MS_BACKEND == "lut":
    cos_im = em.dot(w_i_l, m)
    f = _fresnel_at(scene, sd, cos_im, spectral, swap=~ent)
    d = mf.ggx_d(m, alpha_c)
    w_o_g = torch.where(reflection[..., None], w_o_l,
                        torch.cat([w_o_l[..., :2], -w_o_l[..., 2:3]], dim=-1))
    g = mf.ggx_g1(w_i_l, m, alpha_c) * mf.ggx_g1(w_o_g, m, alpha_c)
    im = cos_im
    om = em.dot(w_o_l, m)
    sqrt_denom = im + eta * om
    # reflection: F D G2 / (4 cos_i |cos_o|)
    f_refl = f * (d * g / torch.clamp(4.0 * cos_i * torch.abs(cos_o), min=1e-9))[..., None]
    # transmission: |im om| (1-F) D G2 / (cos_i |cos_o| (im + eta om)^2): the
    # eta^2 of the Walter term cancels the 1/eta^2 radiance transport factor
    f_tran = (1.0 - f) * (torch.abs(im * om) * d * g / torch.clamp(
        cos_i * torch.abs(cos_o) * em.sqr(sqrt_denom), min=1e-9))[..., None]
    func = torch.where(reflection[..., None], refl_alb * f_refl, scat_alb * f_tran)
    a_iso = torch.sqrt(alpha_c[..., 0] * alpha_c[..., 1])
    comp = energy_lut.dielectric_compensation(torch.clamp(cos_i, min=1e-6), a_iso, eta)
    bsdf = func * (comp * torch.abs(cos_o))[..., None]
  else:
    fres_walk, mono = _walk_fresnel(scene, sd, ent, spectral)
    walk = (cos_i > em.kEpsilon) & ~delta
    value, _ = ms.dielectric_eval_walk(
        fres_walk, mono, eta, w_i_l, w_o_l, reflection, alpha_c, w_o[..., 0] + sd.tex[..., 0],
        w_o[..., 1] + sd.tex[..., 1], active0=walk if mask is None else walk & mask)
    func = 2.0 * value * torch.where(reflection[..., None], refl_alb, scat_alb)
    bsdf = func * torch.abs(cos_o)[..., None]

  pdf = _dielectric_pdf_ref(scene, sd, w_i_l, w_o_l, ent, eta, alpha_c, spectral)
  ok = (cos_i > em.kEpsilon) & (torch.abs(cos_o) > em.kEpsilon) & ~delta
  return torch.where(ok[..., None], bsdf, 0.0), torch.where(ok, pdf, 0.0)


def dielectric_pdf(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False) -> torch.Tensor:
  frame, ent = normal_frame(sd)
  alpha = _roughness(sd, scene)
  alpha_c = mf.clamp_alpha(alpha)
  w_i_l = em.to_local(*frame, -sd.w_i)
  w_o_l = em.to_local(*frame, w_o)
  eta = _crossing_eta(scene, sd, ent, spectral)
  pdf = _dielectric_pdf_ref(scene, sd, w_i_l, w_o_l, ent, eta, alpha_c, spectral)
  ok = ((w_i_l[..., 2] > em.kEpsilon) & (torch.abs(w_o_l[..., 2]) > em.kEpsilon)
        & ~_is_delta_alpha(alpha))
  return torch.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# Thinfilm slab: delta reflect or pass straight through
# ---------------------------------------------------------------------------


def thinfilm_sample(scene, sd: ShadingData, rnd: torch.Tensor, spectral: bool = False) -> BSDFSampleR:
  frame, ent = normal_frame(sd)
  n = frame[2]
  cos_i = em.dot(sd.w_i, sd.nrm)
  f = _fresnel_at(scene, sd, cos_i, spectral)
  f_mono = spx.monochromatic(f, spectral)
  pick_refl = rnd[..., 2] <= f_mono
  w_r = em.normalize(em.reflect(sd.w_i, n))
  w_o = torch.where(pick_refl[..., None], w_r, sd.w_i)
  refl = _reflectance(scene, sd, spectral)
  scat = _scattering(scene, sd, spectral)
  w_reflect = refl * f / torch.clamp(f_mono, min=1e-9)[..., None]
  w_trans = scat * (1.0 - f) / torch.clamp(1.0 - f_mono, min=1e-9)[..., None]
  weight = torch.where(pick_refl[..., None], w_reflect, w_trans)
  pdf = torch.where(pick_refl, f_mono, 1.0 - f_mono)
  medium = torch.where(pick_refl, sd.medium, _crossing_medium(sd, ent))
  r = sd.w_i.shape[0]
  return BSDFSampleR(w_o, weight, pdf, torch.ones(r, device=sd.w_i.device),
                     *_flags(r, sd.w_i.device, True, False, pick_refl), medium)


# ---------------------------------------------------------------------------
# Plastic: a Fresnel-weighted specular layer (the energy-compensated LUT
# reflection lobe under the material's dielectric Fresnel, or the
# dielectric walk on the reflection side) over diffuse
# ---------------------------------------------------------------------------


def plastic_evaluate(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False,
                     mask=None):
  """(bsdf * cos, pdf) toward w_o; under "walk" the specular layer is twice
  the dielectric walk's reflection estimate (walked on the lanes of
  `mask`)."""
  frame, ent = normal_frame(sd)
  w_i_l = em.to_local(*frame, -sd.w_i)
  w_o_l = em.to_local(*frame, w_o)
  cos_i = w_i_l[..., 2]
  cos_o = w_o_l[..., 2]
  ok = (cos_i > em.kEpsilon) & (cos_o > em.kEpsilon)

  alpha = mf.clamp_alpha(_roughness(sd, scene))
  m = em.normalize(w_i_l + w_o_l)
  f = _fresnel_at(scene, sd, em.dot(w_i_l, m), spectral)
  f_mono = spx.monochromatic(f, spectral)

  specular = _reflectance(scene, sd, spectral)
  if MS_BACKEND == "lut":
    def fres_refl(cos_t):
      return _fresnel_at(scene, sd, cos_t, spectral)

    spec_bsdf = energy_lut.conductor_eval_lut(fres_refl, w_i_l, w_o_l, alpha) * specular
  else:
    fres_walk, mono = _walk_fresnel(scene, sd, ent, spectral)
    walk, _ = ms.dielectric_eval_walk(
        fres_walk, mono, _crossing_eta(scene, sd, ent, spectral), w_i_l, w_o_l,
        torch.ones_like(ok), alpha, w_o[..., 0] + sd.tex[..., 0], w_o[..., 1] + sd.tex[..., 1],
        active0=ok if mask is None else ok & mask)
    spec_bsdf = 2.0 * walk * specular
  diff_bsdf = (_scattering(scene, sd, spectral) * (1.0 - f)
               * (em.kInvPi * torch.clamp(cos_o, min=0.0))[..., None])
  bsdf = diff_bsdf + spec_bsdf

  spec_pdf = mf.vndf_pdf(w_i_l, m, alpha) / torch.clamp(4.0 * torch.abs(em.dot(w_o_l, m)),
                                                        min=1e-9)
  pdf = em.kInvPi * torch.clamp(cos_o, min=0.0) * (1.0 - f_mono) + f_mono * spec_pdf
  return torch.where(ok[..., None], bsdf, 0.0), torch.where(ok, pdf, 0.0)


def plastic_sample(scene, sd: ShadingData, rnd: torch.Tensor, spectral: bool = False,
                   mask=None) -> BSDFSampleR:
  """The specular reflection off a visible normal with the Fresnel term's
  probability (columns 0:3), else a cosine-weighted direction (3:5);
  weighted by the full evaluation over its density."""
  frame, _ = normal_frame(sd)
  alpha = mf.clamp_alpha(_roughness(sd, scene))
  w_i_l = _local_w_i(frame, sd)
  m = mf.sample_vndf(rnd[..., 0:2], w_i_l, alpha)
  f_mono = spx.monochromatic(_fresnel_at(scene, sd, em.dot(w_i_l, m), spectral), spectral)

  w_spec_l = em.reflect(-w_i_l, m)
  pick_spec = (rnd[..., 2] <= f_mono) & (w_spec_l[..., 2] > em.kEpsilon)
  w_diff_l = em.sample_cosine_distribution(rnd[..., 3:5], 1.0)
  w_o = em.from_local(*frame, torch.where(pick_spec[..., None], w_spec_l, w_diff_l))

  bsdf, pdf = plastic_evaluate(scene, sd, w_o, spectral, mask=mask)
  weight = torch.where(pdf[..., None] > 0, bsdf / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
  r = sd.w_i.shape[0]
  dev = sd.w_i.device
  return BSDFSampleR(w_o, weight, pdf, torch.ones(r, device=dev),
                     *_flags(r, dev, False, ~pick_spec, True), sd.medium)


def plastic_pdf(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False) -> torch.Tensor:
  frame, _ = normal_frame(sd)
  w_i_l = em.to_local(*frame, -sd.w_i)
  w_o_l = em.to_local(*frame, w_o)
  ok = (w_i_l[..., 2] > em.kEpsilon) & (w_o_l[..., 2] > em.kEpsilon)
  alpha = mf.clamp_alpha(_roughness(sd, scene))
  m = em.normalize(w_i_l + w_o_l)
  f_mono = spx.monochromatic(_fresnel_at(scene, sd, em.dot(w_i_l, m), spectral), spectral)
  spec_pdf = mf.vndf_pdf(w_i_l, m, alpha) / torch.clamp(4.0 * torch.abs(em.dot(w_o_l, m)),
                                                        min=1e-9)
  pdf = em.kInvPi * torch.clamp(w_o_l[..., 2], min=0.0) * (1.0 - f_mono) + f_mono * spec_pdf
  return torch.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# Velvet: a sheen lobe with the analytic L-curve masking
# ---------------------------------------------------------------------------


def _lambda_velvet_l(r, x):
  x = torch.clamp(x, min=0.0)

  def lerp_x(a, b, t):
    return em.sqr(1.0 - t) * a + (1.0 - em.sqr(1.0 - t)) * b

  a = lerp_x(25.3245, 21.5473, r)
  b = lerp_x(3.32435, 3.82987, r)
  c = lerp_x(0.16801, 0.19823, r)
  d = lerp_x(-1.27393, -1.97760, r)
  e = lerp_x(-4.85967, -4.32054, r)
  return a / (1.0 + b * torch.pow(torch.clamp(x, min=1e-9), c)) + d * x + e


def _lambda_velvet(r, cos_t):
  return torch.where(
      cos_t < 0.5, torch.exp(_lambda_velvet_l(r, cos_t)),
      torch.exp(2.0 * _lambda_velvet_l(r, torch.full_like(r, 0.5))
                - _lambda_velvet_l(r, 1.0 - cos_t)))


def velvet_evaluate(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False):
  frame, _ = normal_frame(sd)
  n = frame[2]
  n_dot_o = torch.clamp(em.dot(w_o, n), min=0.0)
  n_dot_i = torch.clamp(-em.dot(sd.w_i, n), min=0.0)
  m = em.normalize(w_o - sd.w_i)
  m_dot_o = torch.clamp(em.dot(w_o, m), min=0.0)
  m_dot_i = torch.clamp(-em.dot(sd.w_i, m), min=0.0)
  ok = ((n_dot_o > em.kEpsilon) & (n_dot_i > em.kEpsilon) & (m_dot_o > em.kEpsilon)
        & (m_dot_i > em.kEpsilon))

  rough = _roughness(sd, scene)
  alpha = 0.5 * (rough[..., 0] + rough[..., 1])
  inv_alpha = 1.0 / (em.kEpsilon + alpha)
  m_dot_n = em.dot(m, n)
  sin_t = torch.clamp(1.0 - m_dot_n * m_dot_n, min=0.0)
  d = (2.0 + inv_alpha) * torch.pow(torch.clamp(sin_t, min=1e-12), 0.5 * inv_alpha) / em.kDoublePi
  g = 1.0 / (1.0 + _lambda_velvet(alpha, n_dot_i) + _lambda_velvet(alpha, n_dot_o))
  spec_scale = torch.where(alpha > em.kEpsilon, 0.25 * d * g / torch.clamp(n_dot_i, min=1e-9), 0.0)

  f90 = 0.5 + 2.0 * alpha * m_dot_o * m_dot_o

  def fres_approx(f0, f90v, cos_t):
    return f0 + (f90v - f0) * torch.pow(torch.clamp(1.0 - cos_t, min=0.0), 5.0)

  diff_scale = fres_approx(1.0, f90, n_dot_o) * fres_approx(1.0, f90, n_dot_i) * em.kInvPi
  bsdf = (_scattering(scene, sd, spectral) * (diff_scale * n_dot_o)[..., None]
          + _reflectance(scene, sd, spectral) * spec_scale[..., None])
  pdf = torch.full(n_dot_o.shape, 1.0 / em.kDoublePi, device=n_dot_o.device)
  return torch.where(ok[..., None], bsdf, 0.0), torch.where(ok, pdf, 0.0)


def velvet_sample(scene, sd: ShadingData, rnd: torch.Tensor, spectral: bool = False) -> BSDFSampleR:
  """A uniform hemisphere direction, weighted by the evaluation over its
  density."""
  frame, _ = normal_frame(sd)
  w_o = em.sample_cosine_distribution_n(rnd[..., 0:2], frame[2], 0.0)
  bsdf, pdf = velvet_evaluate(scene, sd, w_o, spectral)
  weight = torch.where(pdf[..., None] > 0, bsdf / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
  r = sd.w_i.shape[0]
  dev = sd.w_i.device
  return BSDFSampleR(w_o, weight, pdf, torch.ones(r, device=dev),
                     *_flags(r, dev, False, True, True), sd.medium)


def velvet_pdf(scene, sd: ShadingData, w_o: torch.Tensor, spectral: bool = False):
  return velvet_evaluate(scene, sd, w_o, spectral)[1]
