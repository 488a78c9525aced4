"""Multiple-scattering energy compensation through precomputed albedo tables.

Counterpart of `etx_tracer_tpu/render/bsdf/energy_lut.py`, the JAX
package's default backend for rough conductors and dielectrics (its
`MS_BACKEND = "lut"`): a closed-form single-scatter lobe plus a small table
lookup instead of the stochastic Heitz walk,

  f(wi, wo) = F(i.h) D G2 / (4 mu_i)                       (single scatter)
            + F_ms * mu_o (1-E(mu_i))(1-E(mu_o)) / (pi (1-E_avg))

with E(mu, alpha) the directional albedo of the F=1 GGX lobe, E_avg its
cosine average [Kulla & Conty 2017], and F_ms = F_avg^2 E_avg / (1 - F_avg
(1 - E_avg)) with F_avg from a 4-point Gauss-Legendre rule on the lane's
own spectral Fresnel. Dielectrics scale their single-scatter lobe by
1 / E_d(eta, alpha, mu), the escape energy of one VNDF-sampled interface
event. Sampling takes the VNDF reflection with probability E(mu_i) and a
cosine lobe otherwise; weight = f / pdf is analytic.

The numpy table builders are copied from the JAX package verbatim, so both
packages build the same tables; each takes a few seconds and runs once per
process. The JAX package reads them through one-hot matmuls; here a
lookup is the bilinear (or trilinear) gather those matmuls compute. The
Heitz walks (`multiscatter.py`) replace these tables under
`lobes.MS_BACKEND = "walk"`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.render.bsdf import common as mf

_N_MU = 32
_N_ALPHA = 32
_ALPHA_MIN = 1e-3
_ALPHA_MAX = 1.0


def _smith_lambda_np(mu, alpha):
  s2 = np.maximum(1.0 - mu * mu, 1e-12)
  a2 = (mu * mu) / (s2 * alpha * alpha)
  return 0.5 * (-1.0 + np.sqrt(1.0 + 1.0 / np.maximum(a2, 1e-12)))


@functools.lru_cache(maxsize=1)
def _tables_np():
  """E(mu, alpha) and E_avg(alpha) for isotropic GGX, F=1.

  E(mu_i) = int D(h) G2(wi, wo(h)) (wi.h)/mu_i dh over half-vectors
  (wo = reflect(-wi, h), Jacobian dwo = 4(wi.h) dh folded in). Evaluated
  with the exact GGX-NDF inverse-CDF substitution (theta_h =
  atan(a sqrt(u/(1-u)))) so the narrow small-alpha lobe is resolved as
  well as the wide one: sampling h ~ D cos(theta) gives
  E = mean_k [ G2 (wi.h_k) / (mu_i cos(theta_k)) ]. Runs once per process
  in numpy.
  """
  mus = _mu_grid()
  alphas = _alpha_grid()

  n_u, n_phi = 128, 64
  u = (np.arange(n_u) + 0.5) / n_u
  phi = (np.arange(n_phi) + 0.5) * (2.0 * np.pi / n_phi)

  table = np.empty((_N_ALPHA, _N_MU), np.float64)
  for ia, a in enumerate(alphas):
    # h ~ D(h) cos(theta_h): tan^2(theta) = a^2 u/(1-u)
    tan2 = a * a * u / (1.0 - u)
    cos_h = 1.0 / np.sqrt(1.0 + tan2)                      # (U,)
    sin_h = np.sqrt(np.maximum(1.0 - cos_h**2, 0.0))
    hx = sin_h[:, None] * np.cos(phi)[None, :]             # (U, P)
    hy = sin_h[:, None] * np.sin(phi)[None, :]
    hz = np.broadcast_to(cos_h[:, None], hx.shape)
    for im, mu_i in enumerate(mus):
      si = np.sqrt(max(1.0 - mu_i * mu_i, 0.0))
      idoth = si * hx + mu_i * hz                          # wi = (si, 0, mu_i)
      # wo = 2(wi.h)h - wi
      woz = 2.0 * idoth * hz - mu_i
      valid = (idoth > 0.0) & (woz > 1e-6)
      lam_i = _smith_lambda_np(mu_i, a)
      lam_o = _smith_lambda_np(np.clip(woz, 1e-6, 1.0), a)
      g2 = 1.0 / (1.0 + lam_i + lam_o)
      est = np.where(valid, g2 * idoth / (mu_i * hz), 0.0)
      table[ia, im] = est.mean()
  table = np.clip(table, 0.0, 1.0)

  # E_avg = 2 int E(mu) mu dmu on the same mu grid (trapezoid incl. ends)
  mus_ext = np.concatenate([[0.0], mus, [1.0]])
  e_avg = np.empty(_N_ALPHA, np.float64)
  for ia in range(_N_ALPHA):
    e_ext = np.concatenate([[table[ia, 0]], table[ia], [table[ia, -1]]])
    e_avg[ia] = 2.0 * np.trapezoid(e_ext * mus_ext, mus_ext)
  return table.astype(np.float32), np.clip(e_avg, 1e-4, 1.0).astype(np.float32)


def _mu_grid():
  return (np.arange(_N_MU) + 0.5) / _N_MU


def _alpha_grid():
  # log-spaced: resolution where the lobe changes fastest
  return np.exp(np.linspace(np.log(_ALPHA_MIN), np.log(_ALPHA_MAX), _N_ALPHA))


def _mu_grid():
  return (np.arange(_N_MU) + 0.5) / _N_MU


def _alpha_grid():
  # log-spaced: resolution where the lobe changes fastest
  return np.exp(np.linspace(np.log(_ALPHA_MIN), np.log(_ALPHA_MAX), _N_ALPHA))


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
  """A numpy table as a tensor on `device`, made once per device."""
  if name == "e":
    tab = _tables_np()[0]
  elif name == "e_avg":
    tab = _tables_np()[1]
  else:
    tab = _dielectric_tables_np()
  return torch.from_numpy(tab).to(device)


def _alpha_coord(alpha):
  la = torch.log(torch.clamp(alpha, _ALPHA_MIN, _ALPHA_MAX))
  lo, hi = np.log(_ALPHA_MIN), np.log(_ALPHA_MAX)
  return (la - lo) / (hi - lo) * (_N_ALPHA - 1)


def _mu_coord(mu):
  return torch.clamp(mu, 0.0, 1.0) * _N_MU - 0.5


def _cell(c, n: int):
  """Lower grid index, upper grid index and lerp weight of coordinate c."""
  c = torch.clamp(c, 0.0, n - 1.0)
  i0 = torch.floor(c).to(torch.int64)
  return i0, torch.clamp(i0 + 1, max=n - 1), c - i0.to(torch.float32)


def _bilerp(tab, ca, cm):
  """Bilinear (alpha, mu) interpolation of a (N_ALPHA, N_MU) table."""
  a0, a1, fa = _cell(ca, _N_ALPHA)
  m0, m1, fm = _cell(cm, _N_MU)
  r0 = tab[a0, m0] * (1.0 - fa) + tab[a1, m0] * fa
  r1 = tab[a0, m1] * (1.0 - fa) + tab[a1, m1] * fa
  return r0 * (1.0 - fm) + r1 * fm


def e_lookup(mu, alpha_iso):
  """E(mu, alpha): single-scatter directional albedo, bilinear."""
  return _bilerp(_table("e", mu.device), _alpha_coord(alpha_iso), _mu_coord(mu))


def e_avg_lookup(alpha_iso):
  tab = _table("e_avg", alpha_iso.device)
  a0, a1, f = _cell(_alpha_coord(alpha_iso), _N_ALPHA)
  return tab[a0] * (1.0 - f) + tab[a1] * f


# Gauss-Legendre on (0,1) for F_avg = 2 int F(mu) mu dmu. Four nodes are
# exact through polynomial degree 7 — Schlick's mu F(mu) is degree 6, and
# measured conductor F(mu) curves are smoother still; each extra node costs
# a full spectral Fresnel evaluation on the wavefront.
_GL_X, _GL_W = np.polynomial.legendre.leggauss(4)
_GL_MU = (0.5 * (_GL_X + 1.0)).astype(np.float32)
_GL_WT = (0.5 * _GL_W).astype(np.float32)


def fresnel_average(fresnel_fn, shape, device):
  """F_avg = 2 int_0^1 F(mu) mu dmu by 4-point Gauss-Legendre on the lane's
  own (spectral) Fresnel closure. Returns (..., C)."""
  acc = None
  for mu, wt in zip(_GL_MU, _GL_WT):
    f = fresnel_fn(torch.full(shape, float(mu), dtype=torch.float32, device=device))
    term = f * float(2.0 * wt * mu)
    acc = term if acc is None else acc + term
  return torch.clamp(acc, 0.0, 1.0)


def _alpha_iso(alpha):
  return torch.sqrt(alpha[..., 0] * alpha[..., 1])


# ---------------------------------------------------------------------------
# Dielectric single-scatter albedo E_d(eta, alpha, mu): the escape energy of
# one VNDF-sampled interface event with real-Fresnel reflect/refract pick
# (TIR folded into F=1). Drives the multiplicative 1/E_d compensation of
# rough dielectrics.
# ---------------------------------------------------------------------------

_N_ETA = 8
_N_DA = 16      # dielectric-table alpha resolution
_ETA_MAX = 2.5


def _eta_grid():
  # log-symmetric: entering (eta>1) and exiting (eta<1) crossings
  return np.exp(np.linspace(-np.log(_ETA_MAX), np.log(_ETA_MAX), _N_ETA))


def _da_grid():
  return np.exp(np.linspace(np.log(_ALPHA_MIN), np.log(_ALPHA_MAX), _N_DA))


def _fresnel_dielectric_np(cos_i, eta):
  """Real dielectric Fresnel, unpolarized; eta = far/near. TIR -> 1."""
  c = np.clip(cos_i, 0.0, 1.0)
  s2_t = (1.0 - c * c) / np.maximum(eta * eta, 1e-12)
  ct = np.sqrt(np.maximum(1.0 - s2_t, 0.0))
  rs = (c - eta * ct) / np.maximum(c + eta * ct, 1e-12)
  rp = (eta * c - ct) / np.maximum(eta * c + ct, 1e-12)
  return np.where(s2_t >= 1.0, 1.0, 0.5 * (rs * rs + rp * rp))


def _ggx_g1_np(w, m, a):
  """numpy mirror of common.ggx_g1 (isotropic), incl. the sidedness gate."""
  xy_a2 = a * a * (w[..., 0] ** 2 + w[..., 1] ** 2)
  tan2 = xy_a2 / np.maximum(w[..., 2] ** 2, 1e-12)
  g = 2.0 / (1.0 + np.sqrt(1.0 + tan2))
  g = np.where(xy_a2 == 0.0, 1.0, g)
  gate = (w * m).sum(-1) * w[..., 2]
  return np.where(gate <= 0.0, 0.0, g)


def _sample_vndf_np(u1, u2, w_i, a):
  """numpy mirror of common.sample_vndf (isotropic alpha)."""
  v = np.stack([a * w_i[..., 0], a * w_i[..., 1], w_i[..., 2]], -1)
  v = v / np.linalg.norm(v, axis=-1, keepdims=True)
  len2 = v[..., 0] ** 2 + v[..., 1] ** 2
  t1 = np.where(len2[..., None] > 0,
                np.stack([-v[..., 1], v[..., 0], np.zeros_like(len2)], -1)
                / np.sqrt(np.maximum(len2, 1e-20))[..., None],
                np.broadcast_to([1.0, 0.0, 0.0], v.shape))
  t2 = np.cross(v, t1)
  r = np.sqrt(np.maximum(u1, 0.0))
  phi = 2.0 * np.pi * u2
  p1 = r * np.cos(phi)
  p2 = r * np.sin(phi)
  s = 0.5 * (1.0 + v[..., 2])
  p2 = (1.0 - s) * np.sqrt(np.maximum(1.0 - p1 ** 2, 0.0)) + s * p2
  pz = np.sqrt(np.maximum(1.0 - p1 ** 2 - p2 ** 2, 0.0))
  m = (p1[..., None] * t1 + p2[..., None] * t2 + pz[..., None] * v)
  m = np.stack([a * m[..., 0], a * m[..., 1],
                np.maximum(m[..., 2], 1e-6)], -1)
  return m / np.linalg.norm(m, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=1)
def _dielectric_tables_np():
  """E_d(eta, alpha, mu): expected single-scatter sample energy of the
  production dielectric sampler (lobes.dielectric_sample's rough branch),
  mirrored term for term in numpy — m ~ VNDF, analytic expectation over
  the Fresnel reflect/refract pick, SEPARABLE Smith (g2/g1 = G1_o with
  ggx_g1's sidedness gate), branch sign checks included. 1/E_d is then an
  exact-by-construction multiplicative closure for that sampler."""
  mus = _mu_grid()
  alphas = _da_grid()
  etas = _eta_grid()

  n1, n2 = 64, 64
  u1 = ((np.arange(n1) + 0.5) / n1)[:, None]
  u2 = ((np.arange(n2) + 0.5) / n2)[None, :]
  u1 = np.broadcast_to(u1, (n1, n2)).reshape(-1)
  u2 = np.broadcast_to(u2, (n1, n2)).reshape(-1)

  table = np.empty((_N_ETA, _N_DA, _N_MU), np.float64)
  for ia, a in enumerate(alphas):
    for im_, mu_i in enumerate(mus):
      si = np.sqrt(max(1.0 - mu_i * mu_i, 0.0))
      w_i = np.broadcast_to(np.array([si, 0.0, mu_i]), (u1.shape[0], 3))
      m = _sample_vndf_np(u1, u2, w_i, a)
      idoth = (w_i * m).sum(-1)
      w_r = 2.0 * idoth[..., None] * m - w_i
      g1_r = _ggx_g1_np(w_r, m, a) * (w_r[..., 2] > 0.0)
      for ie, eta in enumerate(etas):
        f = _fresnel_dielectric_np(idoth, eta)
        inv_eta = 1.0 / eta
        s2t = np.maximum(0.0, 1.0 - idoth ** 2) * inv_eta ** 2
        cos_t = np.sqrt(np.maximum(1.0 - s2t, 0.0))
        w_t = (-w_i * inv_eta
               + (inv_eta * idoth - cos_t)[..., None] * m)
        w_t = w_t / np.maximum(
            np.linalg.norm(w_t, axis=-1, keepdims=True), 1e-12)
        w_t_f = w_t * np.array([1.0, 1.0, -1.0])
        g1_t = _ggx_g1_np(w_t_f, m, a) * (w_t[..., 2] < 0.0) * (s2t < 1.0)
        table[ie, ia, im_] = (f * g1_r + (1.0 - f) * g1_t).mean()
  return np.clip(table, 1e-3, 1.0).astype(np.float32)


def _da_coord(alpha):
  la = torch.log(torch.clamp(alpha, _ALPHA_MIN, _ALPHA_MAX))
  lo, hi = np.log(_ALPHA_MIN), np.log(_ALPHA_MAX)
  return (la - lo) / (hi - lo) * (_N_DA - 1)


def _eta_coord(eta):
  le = torch.log(torch.clamp(eta, 1.0 / _ETA_MAX, _ETA_MAX))
  lo = -np.log(_ETA_MAX)
  return (le - lo) / (2.0 * np.log(_ETA_MAX)) * (_N_ETA - 1)


def e_dielectric_lookup(mu, alpha_iso, eta):
  """E_d(eta, alpha, mu): trilinear."""
  tab = _table("e_d", mu.device)                 # (E, A, M)
  e0, e1, fe = _cell(_eta_coord(eta), _N_ETA)
  a0, a1, fa = _cell(_da_coord(alpha_iso), _N_DA)
  m0, m1, fm = _cell(_mu_coord(mu), _N_MU)
  w00, w01 = (1.0 - fe) * (1.0 - fa), (1.0 - fe) * fa
  w10, w11 = fe * (1.0 - fa), fe * fa

  def at(m):
    return (tab[e0, a0, m] * w00 + tab[e0, a1, m] * w01
            + tab[e1, a0, m] * w10 + tab[e1, a1, m] * w11)

  return at(m0) * (1.0 - fm) + at(m1) * fm


def dielectric_compensation(mu_i, alpha_iso, eta):
  """Multiplicative MS compensation 1/E_d, clamped to bound the boost."""
  return 1.0 / torch.clamp(e_dielectric_lookup(mu_i, alpha_iso, eta), 0.25, 1.0)


def conductor_eval_lut(fresnel_fn, w_i, w_o, alpha):
  """Energy-compensated conductor eval, cosine folded. w_i/w_o local,
  z > 0 expected."""
  mu_i = torch.clamp(w_i[..., 2], min=1e-6)
  mu_o = torch.clamp(w_o[..., 2], min=0.0)
  a_iso = _alpha_iso(alpha)

  wh = em.normalize(w_i + w_o)
  d = mf.ggx_d(wh, alpha)
  lam_i = mf.smith_lambda(w_i, alpha)
  lam_o = mf.smith_lambda(w_o, alpha)
  g2 = 1.0 / (1.0 + lam_i + lam_o)
  f_ss = fresnel_fn(em.dot(w_i, wh))
  single = f_ss * (d * g2 / (4.0 * mu_i))[..., None]

  e_i = e_lookup(mu_i, a_iso)
  e_o = e_lookup(mu_o, a_iso)
  e_avg = e_avg_lookup(a_iso)
  f_avg = fresnel_average(fresnel_fn, mu_i.shape, mu_i.device)
  denom = 1.0 - f_avg * (1.0 - e_avg)[..., None]
  f_ms = f_avg * f_avg * e_avg[..., None] / torch.clamp(denom, min=1e-4)
  comp = (mu_o * (1.0 - e_i) * (1.0 - e_o)
          / torch.clamp(em.kPi * (1.0 - e_avg), min=1e-5))[..., None] * f_ms

  ok = (w_i[..., 2] > 0.0) & (w_o[..., 2] > 0.0)
  return torch.where(ok[..., None], single + comp, 0.0)


def _mixture_pdf(w_i, w_o, alpha, p_spec):
  wh = em.normalize(w_i + w_o)
  pdf_spec = mf.vndf_pdf(w_i, wh, alpha) / (4.0 * torch.clamp(em.dot(w_o, wh), min=1e-9))
  pdf_cos = torch.clamp(w_o[..., 2], min=0.0) / em.kPi
  return p_spec * pdf_spec + (1.0 - p_spec) * pdf_cos


def conductor_pdf_lut(w_i, w_o, alpha):
  """pdf of conductor_sample_lut's mixture: p_spec * pdf_vndf-reflect +
  (1-p_spec) * cos/pi, so that sampling and evaluation quote one density."""
  mu_i = torch.clamp(w_i[..., 2], min=1e-6)
  p_spec = torch.clamp(e_lookup(mu_i, _alpha_iso(alpha)), 0.05, 1.0)
  return torch.where(w_o[..., 2] > 0.0, _mixture_pdf(w_i, w_o, alpha, p_spec), 0.0)


def conductor_sample_lut(fresnel_fn, w_i, alpha, rnd):
  """Conductor sampling consistent with conductor_eval_lut: with
  probability p = E(mu_i) reflect off a sampled visible normal, otherwise
  sample the cosine-shaped compensation lobe. Returns (w_o local, weight
  (., C), pdf (.,)). rnd: (..., >= 5); columns 0:2 drive the VNDF, 2 the
  lobe choice, 3:5 the compensation direction."""
  mu_i = torch.clamp(w_i[..., 2], min=1e-6)
  p_spec = torch.clamp(e_lookup(mu_i, _alpha_iso(alpha)), 0.05, 1.0)

  m = mf.sample_vndf(rnd[..., 0:2], w_i, alpha)
  w_spec = em.reflect(-w_i, m)
  w_diff = em.sample_cosine_distribution(rnd[..., 3:5], 1.0)
  take_spec = rnd[..., 2] < p_spec
  w_o = torch.where(take_spec[..., None], w_spec, w_diff)
  ok = w_o[..., 2] > em.kEpsilon

  pdf = _mixture_pdf(w_i, w_o, alpha, p_spec)
  f = conductor_eval_lut(fresnel_fn, w_i, w_o, alpha)
  weight = f / torch.clamp(pdf, min=1e-9)[..., None]
  return w_o, torch.where(ok[..., None], weight, 0.0), torch.where(ok, pdf, 0.0)
