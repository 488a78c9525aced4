"""Heitz multiple-scattering microfacet walks, and the vMF rough diffuse.

Counterpart of `etx_tracer_tpu/render/bsdf/multiscatter.py`: the
height-correlated random walks on a microsurface (Heitz et al.,
"Multiple-Scattering Microfacet BSDFs with the Smith Model"), bounded at
kOrderMax = 16 scattering events, for sampling and stochastic evaluation
of a rough conductor (`conductor_sample_walk`, `conductor_eval_walk`), a
rough dielectric (`dielectric_sample_walk`, `dielectric_eval_walk`; the
plastic lobe's specular layer is its eval walk on the reflection side) and
a rough diffuse surface (`diffuse_sample_walk`, `diffuse_eval_walk`), and
the analytic vMF rough-diffuse BRDF of d'Eon & Weidlich
(`vmf_diffuse_brdf`). The lobes take the conductor and dielectric walks
under `lobes.MS_BACKEND = "walk"`; the default "lut" takes none of them.

Each walk draws from a stream of its own, seeded from the bits of two
floats (the sample's spare random columns, or the evaluated direction plus
the uv), so its result for a lane depends on that lane alone. As in the
JAX `lax.while_loop`, a trip runs over the whole wavefront while any lane
of `active0` is active and advances every lane's stream; the loop reads its
condition on the host once a trip. Every walk returns the stream's state
after the loop last, beside its result.
"""

from __future__ import annotations

import numpy as np
import torch

from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.core import rng
from etx_tracer_tpu_torch.render.bsdf import common as mf

kOrderMax = 16
_SQRT_PI = float(np.sqrt(np.float32(em.kPi)))


def _lambda(w, alpha):
  """Smith Lambda of direction w (z may be negative) under anisotropic
  alpha, with the walk's limits at grazing and at the poles."""
  wz = torch.clamp(w[..., 2], -1.0, 1.0)
  sin2 = torch.clamp(1.0 - wz * wz, min=1e-12)
  inv_sin2 = 1.0 / sin2
  cos_phi2 = w[..., 0] * w[..., 0] * inv_sin2
  sin_phi2 = w[..., 1] * w[..., 1] * inv_sin2
  alpha_v = torch.sqrt(cos_phi2 * (alpha[..., 0] * alpha[..., 0])
                       + sin_phi2 * (alpha[..., 1] * alpha[..., 1]))
  tan_theta = torch.sqrt(sin2) / torch.where(torch.abs(wz) < 1e-9, 1e-9, wz)
  ta = tan_theta * alpha_v
  a = 1.0 / torch.where(torch.abs(ta) < 1e-12, 1e-12, ta)
  lam = 0.5 * (-1.0 + torch.sign(a) * torch.sqrt(1.0 + 1.0 / (a * a)))
  lam = torch.where(wz > 0.9999, 0.0, lam)
  return torch.where(wz < -0.9999, -1.0, lam)


def _c1(h):
  return torch.clamp(0.5 * (h + 1.0), 0.0, 1.0)


def _g1(w, lam, c1):
  wz = w[..., 2]
  g = torch.pow(torch.clamp(c1, min=1e-12), torch.clamp(lam, min=0.0))
  return torch.where(wz > 0.9999, 1.0, torch.where(wz <= 0.0, 0.0, g))


def _inv_c1(u):
  return torch.clamp(2.0 * u - 1.0, -1.0, 1.0)


def sample_height(w, lam, c1, g1, h, u):
  """The next height on the microsurface along w from height h; kMaxFloat
  where the ray escapes."""
  wz = w[..., 2]
  p1 = torch.pow(torch.clamp(1.0 - u, min=1e-12),
                 1.0 / torch.where(torch.abs(lam) < 1e-12, 1e-12, lam))
  res_int = _inv_c1(c1 / torch.clamp(p1, min=1e-20))
  escaped = (u > 1.0 - g1) | (p1 <= 0.0)
  res = torch.where(escaped, em.kMaxFloat, res_int)
  res = torch.where(torch.abs(wz) < 1e-4, h, res)
  res = torch.where(wz < -0.9999, _inv_c1(u * c1), res)
  return torch.where(wz > 0.9999, em.kMaxFloat, res)


def _sample_p22_11(theta_i, rnd):
  """A slope of the unit-roughness visible slope distribution at incident
  angle theta_i: (R,2)."""
  sin_t = torch.sin(theta_i)
  cos_t = torch.clamp(torch.cos(theta_i), min=1e-6)
  tan_t = sin_t / cos_t
  proj = 0.5 * (cos_t + 1.0)
  c = 1.0 / torch.clamp(proj, min=1e-6)
  a_ = 2.0 * rnd[..., 0] / cos_t / c - 1.0
  b_ = tan_t
  a2m1 = a_ * a_ - 1.0
  tmp = 1.0 / torch.where(torch.abs(a2m1) < 1e-12, 1e-12, a2m1)
  d_ = torch.sqrt(torch.clamp(b_ * b_ * tmp * tmp - (a_ * a_ - b_ * b_) * tmp, min=0.0))
  sx1 = b_ * tmp - d_
  sx2 = b_ * tmp + d_
  slope_x = torch.where((a_ < 0.0) | (sx2 > 1.0 / torch.clamp(tan_t, min=1e-9)), sx1, sx2)

  big = rnd[..., 1] > 0.5
  s = torch.where(big, 1.0, -1.0)
  u2 = torch.where(big, 2.0 * (rnd[..., 1] - 0.5), 2.0 * (0.5 - rnd[..., 1]))
  z = ((u2 * (u2 * (u2 * 0.27385 - 0.73369) + 0.46341))
       / (u2 * (u2 * (u2 * 0.093073 + 0.309420) - 1.0) + 0.597999))
  slope_y = s * z * torch.sqrt(1.0 + slope_x * slope_x)

  # near-normal incidence
  r = torch.sqrt(rnd[..., 0] / torch.clamp(1.0 - rnd[..., 0], min=1e-9))
  phi = em.kDoublePi * rnd[..., 1]
  near = theta_i < 1e-4
  slope_x = torch.where(near, r * torch.cos(phi), slope_x)
  slope_y = torch.where(near, r * torch.sin(phi), slope_y)
  return torch.stack([slope_x, slope_y], dim=-1)


def sample_microfacet_normal(wi, alpha, rnd):
  """A visible microfacet normal for direction wi, sampled in slope space."""
  wi11 = em.normalize(torch.stack(
      [alpha[..., 0] * wi[..., 0], alpha[..., 1] * wi[..., 1], wi[..., 2]], dim=-1))
  theta = torch.acos(torch.clamp(wi11[..., 2], -1.0, 1.0))
  s11 = _sample_p22_11(theta, rnd)
  phi = torch.atan2(wi11[..., 1], wi11[..., 0])
  cos_p, sin_p = torch.cos(phi), torch.sin(phi)
  sx = (cos_p * s11[..., 0] - sin_p * s11[..., 1]) * alpha[..., 0]
  sy = (sin_p * s11[..., 0] + cos_p * s11[..., 1]) * alpha[..., 1]
  wm = em.normalize(torch.stack([-sx, -sy, torch.ones_like(sx)], dim=-1))
  bad = ~torch.isfinite(sx)
  up = em.constant((0.0, 0.0, 1.0), wi.device).expand(wm.shape)
  flat = em.normalize(torch.stack([wi[..., 0], wi[..., 1], torch.zeros_like(sx)], dim=-1))
  fallback = torch.where((wi[..., 2] > 0.0)[..., None], up, flat)
  return torch.where(bad[..., None], fallback, wm)


def _mis_weight_conductor(wi, wo, alpha):
  wh = em.normalize(wi + wo)
  wh = wh * torch.where(wh[..., 2] > 0, 1.0, -1.0)[..., None]
  d = mf.ggx_d(wh, alpha)
  same = torch.all(torch.abs(wi + wo) < 1e-6, dim=-1)
  return torch.where(same, 1.0, d)


def _seed_from_floats(a, b):
  """A walk's stream, seeded from the bits of two float32 tensors."""
  return rng.seed(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _masked(active, new, old):
  return torch.where(active[..., None] if old.dim() > 1 else active, new, old)


def _start(w_i, c, active0):
  """(h, energy, order, active) at a walk's start."""
  r = w_i.shape[0]
  dev = w_i.device
  active = torch.ones(r, dtype=torch.bool, device=dev) if active0 is None else active0
  return (torch.ones(r, device=dev), torch.ones((r, c), device=dev),
          torch.zeros(r, dtype=torch.int32, device=dev), active)


def conductor_sample_walk(fresnel_fn, w_i, alpha, rnd, active0=None):
  """Sample a rough conductor's microsurface by a random walk. w_i local
  (z > 0, away from the surface), alpha (R,2) clamped, rnd (R, >= 5):
  columns 0:2 the first slope, 3:5 the stream's seed; fresnel_fn(cos) ->
  (R,C). Only the lanes of `active0` walk. Returns (w_o local, energy
  (R,C), zero where the walk did not escape, the stream's state)."""
  r = w_i.shape[0]
  state = _seed_from_floats(rnd[..., 3] + 0.123, rnd[..., 4] + 0.771)
  w = -w_i
  lam = _lambda(w, alpha)
  c = fresnel_fn(torch.ones(r, device=w_i.device)).shape[-1]
  h, energy, order, active = _start(w_i, c, active0)
  escaped = torch.zeros(r, dtype=torch.bool, device=w_i.device)
  while bool(active.any().item()):
    c1 = _c1(h)
    g1 = _g1(w, lam, c1)
    state, u_h = rng.next_float(state)
    h_new = sample_height(w, lam, c1, g1, h, u_h)
    just_escaped = active & (h_new >= em.kMaxFloat * 0.5)
    escaped = escaped | just_escaped
    active = active & ~just_escaped

    state, rnd2 = rng.next_2d(state)
    slope_rnd = torch.where((order == 0)[..., None], rnd[..., 0:2], rnd2)
    wm = sample_microfacet_normal(-w, alpha, slope_rnd)
    i_dot_m = em.dot(-w, wm)
    f = fresnel_fn(i_dot_m)
    w_new = em.normalize(w + 2.0 * wm * i_dot_m[..., None])

    too_many = active & (order + 1 > kOrderMax)
    nan_bad = active & (~torch.isfinite(w_new[..., 2]) | ~torch.isfinite(h_new))
    dead = too_many | nan_bad

    energy = _masked(active, energy * f, energy)
    energy = torch.where(dead[..., None], 0.0, energy)
    w = _masked(active, w_new, w)
    lam = _masked(active, _lambda(w_new, alpha), lam)
    h = _masked(active, h_new, h)
    order = order + active.to(torch.int32)
    active = active & ~dead
  # an escaped lane carries w as its outgoing direction
  return w, torch.where(escaped[..., None], energy, 0.0), state


def conductor_eval_walk(fresnel_fn, w_i, w_o, alpha, seed_a, seed_b, active0=None):
  """Estimate a rough conductor's BSDF, cosine folded in, by one random walk
  from w_i (local, z > 0) scored toward w_o: 0.5 x the single-scattering
  term + the walk's multiple scattering, (R,C). The stream is seeded from
  the bits of seed_a and seed_b. Only the lanes of `active0` walk. Returns
  (the estimate, the stream's state)."""
  r = w_i.shape[0]
  state = _seed_from_floats(seed_a, seed_b)
  wh = em.normalize(w_i + w_o)
  d = mf.ggx_d(wh, alpha)
  lam_i = _lambda(-w_i, alpha)
  lam_o = _lambda(w_o, alpha)
  g2 = 1.0 / (1.0 + (-lam_i - 1.0) + lam_o)
  f_ss = fresnel_fn(em.dot(w_i, wh))
  single = f_ss * (d * g2 / torch.clamp(4.0 * w_i[..., 2], min=1e-9))[..., None]
  c = single.shape[-1]

  def phase_reflection(w, lam, wo):
    proj = torch.where(w[..., 2] < -0.9999, 1.0, lam * w[..., 2])
    whr = em.normalize(-w + wo)
    wdh = em.dot(-w, whr)
    val = fresnel_fn(wdh) * (mf.ggx_d(whr, alpha) / torch.clamp(4.0 * proj, min=1e-9))[..., None]
    ok = ((proj >= em.kEpsilon) & (whr[..., 2] >= 0.0) & (wdh >= em.kEpsilon)
          & (w[..., 2] <= 0.9999))
    return torch.where(ok[..., None], val, 0.0)

  w = -w_i
  lam = lam_i
  h, energy, order, active = _start(w_i, c, active0)
  multiple = torch.zeros((r, c), device=w_i.device)
  wi_mis = torch.zeros(r, device=w_i.device)
  while bool(active.any().item()):
    c1 = _c1(h)
    g1 = _g1(w, lam, c1)
    state, u_h = rng.next_float(state)
    h_new = sample_height(w, lam, c1, g1, h, u_h)
    esc = active & (h_new >= em.kMaxFloat * 0.5)
    active2 = active & ~esc
    order_new = order + active2.to(torch.int32)

    # NEE on the microsurface (order > 1)
    phase = phase_reflection(w, lam, w_o)
    g1_sh = _g1(w_o, lam_o, _c1(h_new))
    i_contrib = energy * phase * g1_sh[..., None]
    mis = wi_mis / torch.clamp(wi_mis + _mis_weight_conductor(-w, w_o, alpha), min=1e-20)
    add = active2 & (order_new > 1)
    multiple = multiple + torch.where(add[..., None], i_contrib * mis[..., None], 0.0)

    # the next direction
    state, rnd2 = rng.next_2d(state)
    wm = sample_microfacet_normal(-w, alpha, rnd2)
    i_dot_m = em.dot(-w, wm)
    f = fresnel_fn(i_dot_m)
    w_new = em.normalize(w + 2.0 * wm * i_dot_m[..., None])
    energy = _masked(active2, energy * f, energy)
    wi_mis = torch.where(active2 & (order_new == 1),
                         _mis_weight_conductor(w_i, w_new, alpha), wi_mis)
    bad = active2 & ((order_new > kOrderMax) | ~torch.isfinite(w_new[..., 2])
                     | ~torch.isfinite(h_new))
    w = _masked(active2, w_new, w)
    lam = _masked(active2, _lambda(w_new, alpha), lam)
    h = _masked(active2, h_new, h)
    order = order_new
    active = active2 & ~bad

  ok = (w_i[..., 2] > 0.0) & (w_o[..., 2] > 0.0)
  return torch.where(ok[..., None], 0.5 * single + multiple, 0.0), state


def _sample_phase_diffuse(wm, rnd):
  """A cosine-lobe direction about the microfacet normal wm."""
  xy = em.sample_disk(rnd)
  x, y = xy[..., 0], xy[..., 1]
  z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
  u, v = em.orthonormal_basis(wm)
  return x[..., None] * u + y[..., None] * v + z[..., None] * wm


def diffuse_sample_walk(w_i, alpha, albedo, rnd, active0=None):
  """Sample the rough-diffuse microsurface by a random walk. w_i local
  (z > 0, away from the surface), alpha (R,2) clamped, albedo (R,C), rnd
  (R, >= 5): columns 0:2 the first slope, 3:5 the stream's seed. Only the
  lanes of `active0` walk. Returns (w_o local, energy (R,C), zero where the
  walk did not escape, and the stream's state after the loop)."""
  state = _seed_from_floats(rnd[..., 3] + 0.377, rnd[..., 4] + 0.911)
  w = -w_i
  lam = _lambda(w, alpha)
  h, energy, order, active = _start(w_i, albedo.shape[-1], active0)
  escaped = torch.zeros(w_i.shape[0], dtype=torch.bool, device=w_i.device)
  while bool(active.any().item()):
    c1 = _c1(h)
    g1 = _g1(w, lam, c1)
    state, u_h = rng.next_float(state)
    h_new = sample_height(w, lam, c1, g1, h, u_h)
    just_escaped = active & (h_new >= em.kMaxFloat * 0.5)
    escaped = escaped | just_escaped
    active = active & ~just_escaped

    state, rnd2 = rng.next_2d(state)
    slope_rnd = torch.where((order == 0)[..., None], rnd[..., 0:2], rnd2)
    wm = sample_microfacet_normal(-w, alpha, slope_rnd)
    state, rnd3 = rng.next_2d(state)
    w_new = _sample_phase_diffuse(wm, rnd3)

    too_many = active & (order + 1 > kOrderMax)
    nan_bad = active & (~torch.isfinite(w_new[..., 2]) | ~torch.isfinite(h_new))
    dead = too_many | nan_bad

    energy = _masked(active, energy * albedo, energy)
    energy = torch.where(dead[..., None], 0.0, energy)
    w = _masked(active, w_new, w)
    lam = _masked(active, _lambda(w_new, alpha), lam)
    h = _masked(active, h_new, h)
    order = order + active.to(torch.int32)
    active = active & ~dead
  return w, torch.where(escaped[..., None], energy, 0.0), state


def diffuse_eval_walk(w_i, w_o, alpha, albedo, seed_a, seed_b, active0=None):
  """Estimate the rough-diffuse BSDF, cosine folded in, by one random walk
  from w_i (local, z > 0) scored toward w_o: (R,C). The stream is seeded
  from the bits of seed_a and seed_b. Only the lanes of `active0` walk.
  Returns (the estimate, the stream's state after the loop)."""
  state = _seed_from_floats(seed_a, seed_b)
  lam_o = _lambda(w_o, alpha)
  w = -w_i
  lam = _lambda(w, alpha)
  h, energy, order, active = _start(w_i, albedo.shape[-1], active0)
  res = torch.zeros_like(energy)
  while bool(active.any().item()):
    c1 = _c1(h)
    g1 = _g1(w, lam, c1)
    state, u_h = rng.next_float(state)
    h_new = sample_height(w, lam, c1, g1, h, u_h)
    esc = active & (h_new >= em.kMaxFloat * 0.5)
    active2 = active & ~esc

    state, rnd2 = rng.next_2d(state)
    wm = sample_microfacet_normal(-w, alpha, rnd2)
    phase = energy * albedo * torch.clamp(em.dot(wm, w_o), min=0.0)[..., None] * em.kInvPi

    # order 0: the closed-form G2/G1; later orders: G1(w_o) at this height
    g2_g1 = -lam / (lam_o - lam)
    first = active2 & (order == 0)
    res = res + torch.where((first & (g2_g1 > 0))[..., None], phase * g2_g1[..., None], 0.0)
    g1_sh = _g1(w_o, lam_o, _c1(h_new))
    later = active2 & (order > 0)
    res = res + torch.where(later[..., None], phase * g1_sh[..., None], 0.0)

    state, rnd3 = rng.next_2d(state)
    w_new = _sample_phase_diffuse(wm, rnd3)
    energy = _masked(active2, energy * albedo, energy)

    bad = active2 & ((order + 1 > kOrderMax) | ~torch.isfinite(w_new[..., 2])
                     | ~torch.isfinite(h_new))
    # a bad walk zeroes the whole estimate
    res = torch.where(bad[..., None], 0.0, res)
    w = _masked(active2, w_new, w)
    lam = _masked(active2, _lambda(w_new, alpha), lam)
    h = _masked(active2, h_new, h)
    order = order + active2.to(torch.int32)
    active = active2 & ~bad
  return res, state


# ---------------------------------------------------------------------------
# vMF rough diffuse (d'Eon & Weidlich, "VMF Diffuse: A Unified Rough Diffuse
# BRDF"), the analytic fit
# ---------------------------------------------------------------------------


def _erf(x):
  """Buermann's series for erf."""
  e = torch.exp(-x * x)
  return (torch.sign(x) * 2.0 / _SQRT_PI * torch.sqrt(1.0 - e)
          * (_SQRT_PI / 2.0 + 31.0 / 200.0 * e - 341.0 / 8000.0 * e * e))


def _fm(ui, uo, r, c):
  big_c = torch.sqrt(torch.clamp(1.0 - c, min=0.0))
  ck = (1.0 - 0.5441615108674713 * big_c - 0.45302863761693374 * (1.0 - c)) / (
      1.0 + 1.4293127703064865 * big_c)
  ca = c / torch.pow(1.0075 + 1.16942 * big_c,
                     torch.atan((0.0225272 + (-0.264641 + r) * r) * _erf(c)))
  return torch.clamp(
      0.384016 * (-0.341969 + ca) * ca * ck
      * (-0.0578978 / (0.287663 + ui * uo) + torch.abs(-0.0898863 + torch.tanh(r))), min=0.0)


def _sigma_beckmann(u, m):
  m2 = torch.clamp(m * m, min=1e-12)
  u = torch.clamp(u, -1.0 + 1e-6, 1.0 - 1e-6)
  u2 = u * u
  expansion = -0.25 * m2 * (u + torch.abs(u))
  t = (torch.exp(u2 / (m2 * (-1.0 + u2))) * m * torch.sqrt(1.0 - u2)) / _SQRT_PI
  return (t + u * (1.0 + _erf(u / (m * torch.sqrt(1.0 - u2))))) / 2.0 + expansion


def _sigma_vmf(u, m):
  """The vMF cross-section fit."""
  m2 = m * m
  m4 = m2 * m2
  m8 = m4 * m4
  u2 = u * u
  u4 = u2 * u2
  u6 = u2 * u4
  u8 = u4 * u4
  u10 = u6 * u4
  u12 = u6 * u6
  arg = torch.clamp(2.0 / torch.clamp(m2, min=1e-6), max=60.0)
  coth2m2 = 1.0 / torch.tanh(arg)
  sinh2m2 = torch.sinh(arg)
  exp2m2 = torch.exp(arg)

  large = (0.25 - 0.25 * u * (m2 - 2.0 * coth2m2)
           + 0.0390625 * (-1.0 + 3.0 * u2) * (4.0 + 3.0 * m4 - 6.0 * m2 * coth2m2))

  q2 = (1.0132789611816406e-6 * (35.0 - 1260.0 * u2 + 6930.0 * u4 - 12012.0 * u6 + 6435.0 * u8)
        * (1.0 + coth2m2)
        * (-256.0 - 315.0 * m4 * (128.0 + 33.0 * m4 * (80.0 + 364.0 * m4 + 195.0 * m8))
           + 18.0 * m2 * (256.0 + 385.0 * m4 * (32.0 + 312.0 * m4 + 585.0 * m8)) * coth2m2)
        * sinh2m2)
  q1 = (9.12696123123169e-8 * (-63.0 + 3465.0 * u2 - 30030.0 * u4 + 90090.0 * u6
                               - 109395.0 * u8 + 46189.0 * u10)
        * (1.0 + coth2m2)
        * (-1024.0 - 495.0 * m4 * (768.0 + 91.0 * m4 * (448.0 + 15.0 * m4 * (
            448.0 + 1836.0 * m4 + 969.0 * m8)))
           + 110.0 * m2 * (256.0 + 117.0 * m4 * (256.0 + 21.0 * m4 * (336.0 + 85.0 * m4 * (
               32.0 + 57.0 * m4)))) * coth2m2)
        * sinh2m2)
  q0 = (4.3655745685100555e-9 * (231.0 - 18018.0 * u2 + 225225.0 * u4 - 1.02102e6 * u6
                                 + 2.078505e6 * u8 - 1.939938e6 * u10 + 676039.0 * u12)
        * (1.0 + coth2m2)
        * (-4096.0 - 3003.0 * m4 * (1024.0 + 45.0 * m4 * (2560.0 + 51.0 * m4 * (
            1792.0 + 285.0 * m4 * (80.0 + 308.0 * m4 + 161.0 * m8))))
           + 78.0 * m2 * (2048.0 + 385.0 * m4 * (1280.0 + 153.0 * m4 * (512.0 + 57.0 * m4 * (
               192.0 + 35.0 * m4 * (40.0 + 69.0 * m4))))) * coth2m2)
        * sinh2m2)

  mid = (large
         - 0.000732421875 * (3.0 - 30.0 * u2 + 35.0 * u4)
         * (16.0 + 180.0 * m4 + 105.0 * m8 - 10.0 * m2 * (8.0 + 21.0 * m4) * coth2m2)
         + 0.000049591064453125 * (-5.0 + 105.0 * u2 - 315.0 * u4 + 231.0 * u6)
         * (64.0 + 105.0 * m4 * (32.0 + 180.0 * m4 + 99.0 * m8)
            - 42.0 * m2 * (16.0 + 240.0 * m4 + 495.0 * m8) * coth2m2)
         + q2 / exp2m2 - q1 / exp2m2 + q0 / exp2m2)

  return torch.where(m < 0.25, _sigma_beckmann(u, m), torch.where(m > 0.9, large, mid))


def vmf_diffuse_brdf(w_i, w_o, alpha, albedo):
  """The vMF rough-diffuse BRDF (no cosine): (R,C). w_i, w_o local, z > 0;
  the Lambert value albedo / pi where the roughness is 0."""
  r = torch.clamp(torch.sqrt(alpha[..., 0] * alpha[..., 1]), 0.0, 1.0 - 4.0 * em.kEpsilon)

  ui = torch.clamp(w_i[..., 2], 1e-5, 1.0)
  uo = torch.clamp(w_o[..., 2], 1e-5, 1.0)
  sin_i = torch.sqrt(torch.clamp(1.0 - ui * ui, min=0.0))
  sin_o = torch.sqrt(torch.clamp(1.0 - uo * uo, min=0.0))
  both = (sin_i > 0.0) & (sin_o > 0.0)
  safe_i = torch.clamp(sin_i, min=1e-9)
  safe_o = torch.clamp(sin_o, min=1e-9)
  cos_phi_diff = torch.where(
      both,
      torch.clamp(torch.clamp(w_i[..., 0] / safe_i, -1, 1) * torch.clamp(w_o[..., 0] / safe_o, -1, 1)
                  + torch.clamp(w_i[..., 1] / safe_i, -1, 1) * torch.clamp(w_o[..., 1] / safe_o, -1, 1),
                  -1.0, 1.0), 0.0)
  phi = torch.acos(cos_phi_diff)

  m = -torch.log(torch.clamp(1.0 - torch.sqrt(r), min=1e-7))
  sigmai = _sigma_vmf(ui, m)
  sigmao = _sigma_vmf(uo, m)
  sigmano = _sigma_vmf(-uo, m)
  sigio = sigmai * sigmao
  sigdenom = torch.clamp(uo * sigmai + ui * sigmano, min=1e-9)

  r2 = r * r
  sqr = torch.sqrt(r)
  r25 = r2 * sqr
  r3 = r * r2
  r4 = r2 * r2
  r45 = r4 * sqr
  r5 = r3 * r2
  ui2 = torch.clamp(ui * ui, 0.0, 1.0)
  uo2 = torch.clamp(uo * uo, 0.0, 1.0)
  sqrtuiuo = torch.sqrt((1.0 - ui2) * (1.0 - uo2))
  uio = torch.clamp(ui + uo, min=1e-6)

  c100 = 1.0 + (-0.1 * r + 0.84 * r4) / (1.0 + 9.0 * r3)
  c101 = (0.0173 * r + 20.4 * r2 - 9.47 * r3) / (1.0 + 7.46 * r)
  c102 = (-0.927 * r + 2.37 * r2) / (1.24 + r2)
  c103 = (-0.110 * r - 1.54 * r2) / (1.0 - 1.05 * r + 7.1 * r2)
  f10 = ((c100 + c101 * ui * uo + c102 * ui2 * uo2 + c103 * (ui2 + uo2)) * sigio) / sigdenom

  c110 = (0.54 * r - 0.182 * r3) / (1.0 + 1.32 * r2)
  c111 = (-0.097 * r + 0.62 * r2 - 0.375 * r3) / (1.0 + 0.4 * r3)
  c112 = 0.283 + 0.862 * r - 0.681 * r2
  f11 = ((sqrtuiuo * (c110 + c111 * ui * uo))
         * torch.pow(torch.clamp(sigio, min=1e-12), c112) / sigdenom)

  c120 = (2.25 * r + 5.1 * r2) / (1.0 + 9.8 * r + 32.4 * r2)
  c121 = (-4.32 * r + 6.0 * r3) / (1.0 + 9.7 * r + 287.0 * r3)
  f12 = ((1.0 - ui2) * (1.0 - uo2) * (c120 + c121 * uo) * (c120 + c121 * ui)) / uio

  c200 = (0.00056 * r + 0.226 * r2) / (1.0 + 7.07 * r2)
  c201 = (-0.268 * r + 4.57 * r2 - 12.04 * r3) / (1.0 + 36.7 * r3)
  c202 = (0.418 * r + 2.52 * r2 - 0.97 * r3) / (1.0 + 10.0 * r2)
  c203 = (0.068 * r - 2.25 * r2 + 2.65 * r3) / (1.0 + 21.4 * r3)
  c204 = (0.050 * r - 4.22 * r3) / (1.0 + 17.6 * r2 + 43.1 * r3)
  f20 = (c200 + c201 * ui * uo + c203 * ui2 * uo2 + c202 * (ui + uo) + c204 * (ui2 + uo2)) / uio

  c210 = (-0.049 * r - 0.027 * r3) / (1.0 + 3.36 * r2)
  c211 = (2.77 * r2 - 8.332 * r25 + 6.073 * r3) / (1.0 + 50.0 * r4)
  c212 = (-0.431 * r2 - 0.295 * r3) / (1.0 + 23.9 * r3)
  f21 = (sqrtuiuo * (c210 + c211 * ui * uo + c212 * (ui + uo))) / uio

  c300 = (-0.083 * r3 + 0.262 * r4) / (1.0 - 1.9 * r2 + 38.6 * r4)
  c301 = (-0.627 * r2 + 4.95 * r25 - 2.44 * r3) / (1.0 + 31.5 * r4)
  c302 = (0.33 * r2 + 0.31 * r25 + 1.4 * r3) / (1.0 + 20.0 * r3)
  c303 = (-0.74 * r2 + 1.77 * r25 - 4.06 * r3) / (1.0 + 215.0 * r5)
  c304 = (-1.026 * r3) / (1.0 + 5.81 * r2 + 13.2 * r3)
  f30 = (c300 + c301 * ui * uo + c303 * ui2 * uo2 + c302 * (ui + uo) + c304 * (ui2 + uo2)) / uio

  c310 = (0.028 * r2 - 0.0132 * r3) / (1.0 + 7.46 * r2 - 3.315 * r4)
  c311 = (-0.134 * r2 + 0.162 * r25 + 0.302 * r3) / (1.0 + 57.5 * r45)
  c312 = (-0.119 * r2 + 0.5 * r25 - 0.207 * r3) / (1.0 + 18.7 * r3)
  f31 = (sqrtuiuo * (c310 + c311 * ui * uo + c312 * (ui + uo))) / uio

  a = albedo
  cos_phi = torch.cos(phi)
  t0 = a * torch.clamp(f10 + f11 * cos_phi * 2.0 + f12 * torch.cos(2.0 * phi) * 2.0,
                       min=0.0)[..., None]
  t1 = a * a * torch.clamp(f20 + f21 * cos_phi * 2.0, min=0.0)[..., None]
  t2 = a * a * a * torch.clamp(f30 + f31 * cos_phi * 2.0, min=0.0)[..., None]
  t4 = _fm(ui[..., None], uo[..., None], r[..., None], a)
  result = em.kInvPi * (t0 + t1 + t2) + t4
  return torch.where((r > 0.0)[..., None], result, albedo * em.kInvPi)


# ---------------------------------------------------------------------------
# The Heitz dielectric walk
# ---------------------------------------------------------------------------


def _refract_local(wi, wm, eta):
  """wi refracted through the microfacet normal wm; eta (R,) the far side's
  index over the near side's."""
  cos_i = em.dot(wi, wm)
  cos_t2 = 1.0 - (1.0 - cos_i * cos_i) / (eta * eta)
  cos_t = -torch.sqrt(torch.clamp(cos_t2, min=0.0))
  return wm * (cos_i / eta + cos_t)[..., None] - wi / eta[..., None]


def _abgam(x):
  g = (1.0 / 12.0, 1.0 / 30.0, 53.0 / 210.0, 195.0 / 371.0,
       22999.0 / 22737.0, 29944523.0 / 19733142.0, 109535241009.0 / 48264275462.0)
  k = 0.918938518
  cont = g[6] / x
  for gi in (g[5], g[4], g[3], g[2], g[1]):
    cont = gi / (x + cont)
  return k - x + (x - 0.5) * torch.log(x) + g[0] / (x + cont)


def _gamma_fn(x):
  return torch.exp(_abgam(x + 5.0)) / (x * (x + 1.0) * (x + 2.0) * (x + 3.0) * (x + 4.0))


def _beta_fn(m, n):
  return _gamma_fn(m) * _gamma_fn(n) / torch.clamp(_gamma_fn(m + n), min=1e-20)


def _dielectric_step(fresnel_fn, mono_fn, eta, alpha, w, outside, slope_rnd, refl_rnd):
  """One scattering event of the dielectric walk at the lanes' current
  direction w (travelling) and side: (the new direction, the
  event's Fresnel response, whether it reflected)."""
  wi_cur = -w
  wm = sample_microfacet_normal(wi_cur, alpha, slope_rnd)
  i_dot_m = em.dot(wi_cur, wm)
  f = fresnel_fn(i_dot_m, outside)
  reflect = refl_rnd < mono_fn(f)
  eta_cur = torch.where(outside, eta, 1.0 / eta)
  w_refl = -wi_cur + 2.0 * wm * i_dot_m[..., None]
  w_refr = em.normalize(_refract_local(wi_cur, wm, eta_cur))
  return torch.where(reflect[..., None], w_refl, -w_refr), f, reflect


def dielectric_sample_walk(fresnel_fn, mono_fn, eta, w_i, alpha, rnd, active0=None):
  """Sample a rough dielectric's microsurface by a random walk. w_i local
  with z > 0 (the caller folds the side in); fresnel_fn(cos, outside) ->
  (R,C); mono_fn collapses a response to (R,); eta (R,): the inner index
  over the outer for the walk's starting side; rnd (R, >= 5): columns 0:2
  the first slope, 2 the first reflect-or-refract draw, 3:5 the stream's
  seed. Only the lanes of `active0` walk.

  Returns (w_o local, weight (R,C), zero where the walk did not escape,
  outside (R,) bool, escaped (R,) bool, the stream's state); w_o is in the
  walk's frame."""
  r = w_i.shape[0]
  dev = w_i.device
  state = _seed_from_floats(rnd[..., 3] + 0.531, rnd[..., 4] + 0.207)
  c = fresnel_fn(torch.ones(r, device=dev), torch.ones(r, dtype=torch.bool, device=dev)).shape[-1]
  w = -w_i
  lam = _lambda(w, alpha)
  h, energy, order, active = _start(w_i, c, active0)
  outside = torch.ones(r, dtype=torch.bool, device=dev)
  escaped = torch.zeros(r, dtype=torch.bool, device=dev)
  while bool(active.any().item()):
    c1 = _c1(h)
    g1 = _g1(w, lam, c1)
    state, u_h = rng.next_float(state)
    h_new = sample_height(w, lam, c1, g1, h, u_h)
    just_escaped = active & (h_new >= em.kMaxFloat * 0.5)
    escaped = escaped | just_escaped
    active = active & ~just_escaped
    h = _masked(active, h_new, h)

    state, rnd2 = rng.next_2d(state)
    state, rnd_r = rng.next_float(state)
    first = order == 0
    slope_rnd = torch.where(first[..., None], rnd[..., 0:2], rnd2)
    refl_rnd = torch.where(first, rnd[..., 2], rnd_r)
    new_w, f, reflect = _dielectric_step(fresnel_fn, mono_fn, eta, alpha, w, outside,
                                         slope_rnd, refl_rnd)
    energy = _masked(active, energy * torch.where(reflect[..., None], f, 1.0 - f), energy)
    h = torch.where(active & ~reflect, -h, h)
    outside = outside ^ (active & ~reflect)

    too_many = active & (order + 1 > kOrderMax)
    nan_bad = active & (~torch.isfinite(new_w[..., 2]) | ~torch.isfinite(h))
    dead = too_many | nan_bad
    energy = torch.where(dead[..., None], 0.0, energy)

    w = _masked(active, new_w, w)
    lam = _masked(active, _lambda(w, alpha), lam)
    order = order + active.to(torch.int32)
    active = active & ~dead
  w_o = torch.where(outside[..., None], w, -w)
  return w_o, torch.where(escaped[..., None], energy, 0.0), outside, escaped, state


def _phase_reflection_d(fresnel_fn, w, lam, wo, alpha, outside):
  """The reflection phase function of the microsurface toward wo."""
  proj = torch.where(w[..., 2] < -0.9999, 1.0, lam * w[..., 2])
  wh = em.normalize(-w + wo)
  wdh = em.dot(-w, wh)
  d = mf.ggx_d(wh, alpha)
  val = fresnel_fn(wdh, outside) * (d / torch.clamp(4.0 * proj, min=1e-9))[..., None]
  ok = ((w[..., 2] <= 0.9999) & (proj >= em.kEpsilon)
        & (wh[..., 2] >= 0.0) & (wdh >= em.kEpsilon))
  return torch.where(ok[..., None], val, 0.0)


def _phase_transmission_d(fresnel_fn, w, lam, wo, eta_rel, alpha, outside):
  """The transmission phase function of the microsurface toward wo."""
  proj = torch.where(w[..., 2] < -0.9999, 1.0, lam * w[..., 2])
  wh = em.normalize(-w + wo * eta_rel[..., None])
  wh = wh * torch.where(wh[..., 2] > 0, 1.0, -1.0)[..., None]
  i_dot_m = -em.dot(wh, w)
  o_dot_m = em.dot(wo, wh)
  d = mf.ggx_d(wh, alpha)
  scalar = (eta_rel * eta_rel * i_dot_m * torch.clamp(-o_dot_m, min=0.0) * d
            / torch.clamp(proj * em.sqr(i_dot_m + eta_rel * o_dot_m), min=1e-12))
  val = (1.0 - fresnel_fn(i_dot_m, outside)) * scalar[..., None]
  ok = (w[..., 2] <= 0.9999) & (proj >= em.kEpsilon) & (i_dot_m >= 0.0)
  return torch.where(ok[..., None], val, 0.0)


def _mis_weight_dielectric(wi, wo, reflection, eta, alpha):
  wh_r = em.normalize(wi + wo)
  wh_t = em.normalize(wi + wo * eta[..., None])
  wh = torch.where(reflection[..., None], wh_r, wh_t)
  wh = wh * torch.where(wh[..., 2] > 0, 1.0, -1.0)[..., None]
  d = mf.ggx_d(wh, alpha)
  same = reflection & torch.all(torch.abs(wi + wo) < 1e-6, dim=-1)
  return torch.where(same, 1.0, d)


def dielectric_eval_walk(fresnel_fn, mono_fn, eta, w_i, w_o, wo_outside, alpha, seed_a, seed_b,
                         active0=None):
  """Estimate a rough dielectric's BSDF by one random walk from w_i (local,
  z > 0) scored toward w_o: 0.5 x the single-scattering term + the walk's
  multiple scattering, (R,C). wo_outside (R,) bool: w_o leaves on the
  incident side (a reflection). The stream is seeded from the bits of
  seed_a and seed_b. Only the lanes of `active0` walk. Returns (the
  estimate, the stream's state)."""
  r = w_i.shape[0]
  dev = w_i.device
  state = _seed_from_floats(seed_a, seed_b)
  c = fresnel_fn(torch.ones(r, device=dev), torch.ones(r, dtype=torch.bool, device=dev)).shape[-1]
  wo_sh = torch.where(wo_outside[..., None], w_o, -w_o)
  lam_sh = _lambda(wo_sh, alpha)

  w = -w_i
  lam = _lambda(w, alpha)
  h, energy, order, active = _start(w_i, c, active0)
  outside = torch.ones(r, dtype=torch.bool, device=dev)
  single = torch.zeros((r, c), device=dev)
  multiple = torch.zeros((r, c), device=dev)
  wi_mis = torch.zeros(r, device=dev)
  while bool(active.any().item()):
    c1 = _c1(h)
    g1 = _g1(w, lam, c1)
    state, u_h = rng.next_float(state)
    h_new = sample_height(w, lam, c1, g1, h, u_h)
    esc = active & (h_new >= em.kMaxFloat * 0.5)
    active2 = active & ~esc
    h = _masked(active2, h_new, h)
    order_new = order + active2.to(torch.int32)

    # next-event estimation toward w_o: a reflection-type phase where the
    # walk is on w_o's side, else a transmission
    refl_cfg = outside == wo_outside
    eta_rel = torch.where(outside, eta, 1.0 / eta)
    wo_tgt = torch.where(outside[..., None], w_o, -w_o)
    ph_r = _phase_reflection_d(fresnel_fn, w, lam, wo_tgt, alpha, outside)
    ph_t = _phase_transmission_d(fresnel_fn, w, lam, wo_tgt, eta_rel, alpha, outside)
    phase = torch.where(refl_cfg[..., None], ph_r, ph_t)

    # single scattering: the closed-form G2/G1 (order 1)
    g2_g1_refl = (1.0 + (-lam - 1.0)) / (1.0 + (-lam - 1.0) + lam_sh)
    g2_g1_tran = (1.0 + (-lam - 1.0)) * _beta_fn(
        torch.clamp(1.0 + (-lam - 1.0), min=1e-4), torch.clamp(1.0 + lam_sh, min=1e-4))
    g2_g1 = torch.where(wo_outside, g2_g1_refl, g2_g1_tran)
    g2_g1 = torch.where(torch.isfinite(g2_g1), g2_g1, 0.0)
    is_first = active2 & (order_new == 1)
    single = torch.where(is_first[..., None], phase * g2_g1[..., None], single)

    # multiple scattering: shadowing G1 and the microsurface MIS (order > 1)
    mis_other = _mis_weight_dielectric(-w, wo_tgt, refl_cfg, eta_rel, alpha)
    mis = wi_mis / torch.clamp(wi_mis + mis_other, min=1e-20)
    h_sh = torch.where(outside == wo_outside, h, -h)
    g1_sh = _g1(wo_sh, lam_sh, _c1(h_sh))
    later = active2 & (order_new > 1)
    multiple = multiple + torch.where(later[..., None], phase * (g1_sh * mis)[..., None], 0.0)

    # the next direction
    state, rnd2 = rng.next_2d(state)
    state, rnd_r = rng.next_float(state)
    new_w, _, reflect = _dielectric_step(fresnel_fn, mono_fn, eta, alpha, w, outside,
                                         rnd2, rnd_r)
    h = torch.where(active2 & ~reflect, -h, h)
    outside = outside ^ (active2 & ~reflect)
    wi_mis = torch.where(active2 & (order_new == 1),
                         _mis_weight_dielectric(w_i, new_w, reflect, eta, alpha), wi_mis)

    bad = active2 & ((order_new > kOrderMax) | ~torch.isfinite(new_w[..., 2])
                     | ~torch.isfinite(h) | (torch.abs(new_w[..., 2]) <= em.kEpsilon))
    single = torch.where(bad[..., None], 0.0, single)
    multiple = torch.where(bad[..., None], 0.0, multiple)
    w = _masked(active2, new_w, w)
    lam = _masked(active2, _lambda(w, alpha), lam)
    order = order_new
    active = active2 & ~bad
  return 0.5 * single + multiple, state
