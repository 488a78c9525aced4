"""Shared microfacet and Fresnel machinery.

Counterpart of `etx_tracer_tpu/render/bsdf/common.py`, function for
function. Everything works in the local shading frame (z = normal) on
batched tensors. GGX follows the visible-NDF formulation; `ms_pdf` is the
`D / ((1 + Lambda) 4 cos_i) + cos_o` density of the multiple-scattering
conductor and dielectric lobes.

The complex Fresnel terms are written on (re, im) pairs of real tensors, as
in the JAX package (whose TPU backend has no complex dtype), so that the
port rounds as the reference does.
"""

from __future__ import annotations

import torch

from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.core import spectrum as sp

kMinAlpha = 1.0 / 256.0


def clamp_alpha(a: torch.Tensor) -> torch.Tensor:
  return torch.clamp(a, min=kMinAlpha)


def ggx_d(m: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
  """Anisotropic GGX NDF in the local frame. m: (..., 3), alpha: (..., 2)."""
  ax = alpha[..., 0]
  ay = alpha[..., 1]
  t = em.sqr(m[..., 0] / ax) + em.sqr(m[..., 1] / ay) + em.sqr(m[..., 2])
  return 1.0 / torch.clamp(em.kPi * ax * ay * em.sqr(t), min=1e-20)


def smith_lambda(w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
  """Smith Lambda of the height-correlated masking term, with the
  anisotropic alpha projected onto the direction."""
  wz = w[..., 2]
  sin2 = torch.clamp(1.0 - em.sqr(wz), min=1e-12)
  inv_sin2 = em.sqr(wz) / sin2
  cos_phi2 = em.sqr(w[..., 0]) / sin2
  sin_phi2 = em.sqr(w[..., 1]) / sin2
  alpha_proj2 = cos_phi2 * em.sqr(alpha[..., 0]) + sin_phi2 * em.sqr(alpha[..., 1])
  a2 = inv_sin2 / torch.clamp(alpha_proj2, min=1e-12)
  lam = 0.5 * (-1.0 + torch.sqrt(1.0 + 1.0 / torch.clamp(a2, min=1e-12)))
  return torch.where(torch.abs(wz) >= 1.0, 0.0, lam)


def ggx_g1(w: torch.Tensor, m: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
  """Smith masking G1."""
  xy_alpha2 = em.sqr(alpha[..., 0] * w[..., 0]) + em.sqr(alpha[..., 1] * w[..., 1])
  tan2 = xy_alpha2 / torch.clamp(em.sqr(w[..., 2]), min=1e-12)
  g = 2.0 / (1.0 + torch.sqrt(1.0 + tan2))
  g = torch.where(xy_alpha2 == 0.0, 1.0, g)
  return torch.where(em.dot(w, m) * w[..., 2] <= 0.0, 0.0, g)


def sample_vndf(rnd: torch.Tensor, w_i: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
  """Sample a visible normal. w_i: local incident direction with z > 0
  (pointing away from the surface)."""
  ax = alpha[..., 0:1]
  ay = alpha[..., 1:2]
  v_h = em.normalize(torch.cat([ax * w_i[..., 0:1], ay * w_i[..., 1:2], w_i[..., 2:3]], dim=-1))
  len2 = em.sqr(v_h[..., 0]) + em.sqr(v_h[..., 1])
  u = torch.where(
      (len2 > 0.0)[..., None],
      torch.stack([-v_h[..., 1], v_h[..., 0], torch.zeros_like(len2)], dim=-1)
      / torch.sqrt(torch.clamp(len2, min=1e-20))[..., None],
      em.constant((1.0, 0.0, 0.0), v_h.device).expand(v_h.shape))
  v = em.cross(v_h, u)
  r = torch.sqrt(torch.clamp(rnd[..., 0], min=0.0))
  phi = em.kDoublePi * rnd[..., 1]
  t1 = r * torch.cos(phi)
  t2 = r * torch.sin(phi)
  s = 0.5 * (1.0 + v_h[..., 2])
  t2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - t1 * t1, min=0.0)) + s * t2
  n_h = (t1[..., None] * u + t2[..., None] * v
         + torch.sqrt(torch.clamp(1.0 - t1 * t1 - t2 * t2, min=0.0))[..., None] * v_h)
  return em.normalize(torch.cat(
      [ax * n_h[..., 0:1], ay * n_h[..., 1:2], torch.clamp(n_h[..., 2:3], min=0.0)], dim=-1))


def vndf_pdf(w_i: torch.Tensor, m: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
  """pdf of sample_vndf: D(m) G1(w_i) |w_i.m| / cos_i."""
  d = ggx_d(m, alpha)
  g1 = ggx_g1(w_i, m, alpha)
  s = torch.abs(em.dot(w_i, m)) / torch.clamp(w_i[..., 2], min=1e-9)
  return d * g1 * s


def ms_pdf(w_i: torch.Tensor, w_o: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
  """D(wh) / ((1 + Lambda(w_i)) 4 cos_i) + cos_o."""
  wh = em.normalize(w_i + w_o)
  d = ggx_d(wh, alpha)
  lam = smith_lambda(w_i, alpha)
  return (d / ((1.0 + lam) * 4.0 * torch.clamp(w_i[..., 2], min=1e-9))
          + torch.clamp(w_o[..., 2], min=0.0))


# ---------------------------------------------------------------------------
# Fresnel on (re, im) pairs.
# ---------------------------------------------------------------------------


def _cmul(a, b):
  return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cdiv(a, b):
  d = b[0] * b[0] + b[1] * b[1]
  d = torch.where(d == 0.0, 1e-30, d)
  return (a[0] * b[0] + a[1] * b[1]) / d, (a[1] * b[0] - a[0] * b[1]) / d


def _csqrt(a):
  r = torch.sqrt(torch.clamp(a[0] * a[0] + a[1] * a[1], min=0.0))
  re = torch.sqrt(torch.clamp(0.5 * (r + a[0]), min=0.0))
  im = torch.sqrt(torch.clamp(0.5 * (r - a[0]), min=0.0)) * torch.where(a[1] < 0.0, -1.0, 1.0)
  return re, im


def _cabs2(a):
  return a[0] * a[0] + a[1] * a[1]


def _csub(a, b):
  return a[0] - b[0], a[1] - b[1]


def _cadd(a, b):
  return a[0] + b[0], a[1] + b[1]


def _cscale(a, s):
  return a[0] * s, a[1] * s


def _reflectance_c(ni, cos_i, nj, cos_j):
  """Complex rs, rp."""
  a = _cmul(ni, cos_i)
  b = _cmul(nj, cos_j)
  rs = _cdiv(_csub(a, b), _cadd(a, b))
  c = _cmul(nj, cos_i)
  e = _cmul(ni, cos_j)
  rp = _cdiv(_csub(c, e), _cadd(c, e))
  return rs, rp


def _transmittance_c(ni, cos_i, nj, cos_j):
  two_ni_ci = _cscale(_cmul(ni, cos_i), 2.0)
  ts = _cdiv(two_ni_ci, _cadd(_cmul(ni, cos_i), _cmul(nj, cos_j)))
  tp = _cdiv(two_ni_ci, _cadd(_cmul(ni, cos_j), _cmul(nj, cos_i)))
  return ts, tp


def _one(x):
  return torch.ones_like(x), torch.zeros_like(x)


def fresnel_generic(cos_theta_i, ext_ior, int_ior):
  """|F| for complex IORs. ext_ior/int_ior: (re, im) pairs of tensors."""
  cos_i = (cos_theta_i, torch.zeros_like(cos_theta_i))
  ratio = _cdiv(ext_ior, int_ior)
  ratio2 = _cmul(ratio, ratio)
  one_minus_c2 = _csub(_one(cos_theta_i), _cmul(cos_i, cos_i))
  sin2_o = _cmul(ratio2, one_minus_c2)
  cos_o = _csqrt(_csub(_one(sin2_o[0]), sin2_o))
  rs, rp = _reflectance_c(ext_ior, cos_i, int_ior, cos_o)
  f = 0.5 * (_cabs2(rs) + _cabs2(rp))
  same = (ext_ior[0] == int_ior[0]) & (ext_ior[1] == int_ior[1])
  return torch.where(same, 0.0, f)


def fresnel_thinfilm(wavelength, cos_theta_0, ext_ior, film_ior, int_ior, thickness):
  """Thin-film interference Fresnel."""
  one = _one(cos_theta_0)
  cos0 = (cos_theta_0, torch.zeros_like(cos_theta_0))

  r01 = _cdiv(ext_ior, film_ior)
  sin1_2 = _cmul(_cmul(r01, r01), _csub(one, _cmul(cos0, cos0)))
  cos1 = _csqrt(_csub(one, sin1_2))
  r12 = _cdiv(film_ior, int_ior)
  sin2_2 = _cmul(_cmul(r12, r12), _csub(one, _cmul(cos1, cos1)))
  cos2 = _csqrt(_csub(one, sin2_2))

  ratio = _cdiv(_cmul(int_ior, cos2), _cmul(ext_ior, cos0))

  delta10 = torch.where(ext_ior[0] < film_ior[0], em.kPi, 0.0)
  delta21 = torch.where(film_ior[0] < int_ior[0], em.kPi, 0.0)
  phase_shift = delta10 + delta21

  r01s, r01p = _reflectance_c(ext_ior, cos0, film_ior, cos1)
  t01s, t01p = _transmittance_c(ext_ior, cos0, film_ior, cos1)
  r12s, r12p = _reflectance_c(film_ior, cos1, int_ior, cos2)
  t12s, t12p = _transmittance_c(film_ior, cos1, int_ior, cos2)

  # phi = (4 pi thickness cos1 + phase_shift film_ior) / wavelength (complex)
  phi = (em.kDoublePi * 2.0 * thickness * cos1[0] + phase_shift * film_ior[0],
         em.kDoublePi * 2.0 * thickness * cos1[1] + phase_shift * film_ior[1])
  phi = (phi[0] / wavelength, phi[1] / wavelength)
  # e = exp(i phi) for complex phi: exp(i a - b) = e^{-b} (cos a + i sin a)
  amp = torch.exp(-phi[1])
  e = (amp * torch.cos(phi[0]), amp * torch.sin(phi[0]))

  def lobe(t01, t12, r01x, r12x):
    num = _cmul(t01, t12)
    den = _csub(one, _cmul(_cmul(r01x, r12x), e))
    q = _cdiv(num, den)
    return _cmul(q, q)

  tp = lobe(t01p, t12p, r01p, r12p)
  ts = lobe(t01s, t12s, r01s, r12s)
  inner = _csub(one, _cmul(ratio, _cscale(_cadd(tp, ts), 0.5)))
  f = torch.sqrt(torch.clamp(_cabs2(inner), min=0.0))
  tir = (sin1_2[0] >= 1.0) | (sin2_2[0] >= 1.0)
  f = torch.where(tir, 1.0, f)
  return torch.where(cos_theta_0 == 0.0, 0.0, f)


_RGB_LUM_SCALE = (0.817660332, 1.05418909, 1.09945524)


def fresnel(cos_theta, ext_eta, ext_k, int_eta, int_k, spectral: bool,
            int_is_conductor=None, tf_thickness=None, tf_eta=None, tf_k=None,
            tf_wavelengths=None):
  """Per-channel complex Fresnel. eta/k inputs are (R, C) responses;
  returns (R, C). Where a thin film is present (tf_thickness > 0 and a
  nonzero tf_eta) the interference form is used."""
  cos_t = torch.abs(cos_theta)[..., None].expand(ext_eta.shape)
  ni = (ext_eta, ext_k)
  nj = (int_eta, int_k)
  f = fresnel_generic(cos_t, ni, nj)
  if not spectral and int_is_conductor is not None:
    # conductor values convert as XYZ -> RGB with the luminance-basis scale
    conv = sp.xyz_to_rgb(f) * em.constant(_RGB_LUM_SCALE, f.device)
    f = torch.where(int_is_conductor[..., None], conv, f)
  if tf_thickness is not None:
    nf = (tf_eta, tf_k)
    use_tf = ((tf_thickness > 0.0)[..., None]
              & (torch.amax(torch.abs(tf_eta), dim=-1, keepdim=True) > 0.0))
    f = torch.where(use_tf, fresnel_thinfilm(tf_wavelengths, cos_t, ni, nf, nj,
                                             tf_thickness[..., None]), f)
  return em.saturate(f)
