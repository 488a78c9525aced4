"""Participating media: the Henyey-Greenstein phase function, free-path
sampling and transmittance.

Counterpart of `etx_tracer_tpu/render/media.py`: homogeneous media sample
free paths analytically with spectral-channel MIS; heterogeneous media
delta-track through the density grid for a free path and ratio-track for a
transmittance. Both tracking loops run over the whole wavefront while any
lane is active, with no cap, and every iteration draws from every lane's
RNG, active or not, as the JAX `lax.while_loop`s do: a lane's stream after a
loop depends on the loop's trip count, so the loops are never compacted or
cut short. Each iteration reads its condition on the host once.

Sums over the colour channels are written out term by term, ((r + g) + b).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.core import rng
from etx_tracer_tpu_torch.render import spectral as spx


def csum(v: torch.Tensor) -> torch.Tensor:
  """Sum over the trailing channel axis (1 or 3 channels), in order."""
  if v.shape[-1] == 1:
    return v[..., 0]
  return v[..., 0] + v[..., 1] + v[..., 2]


def phase_hg(w_i, w_o, g):
  """Henyey-Greenstein phase function."""
  cos_t = em.dot(w_i, w_o)
  d = 1.0 + g * g - 2.0 * g * cos_t
  return ((1.0 / (4.0 * em.kPi)) * (1.0 - g * g)
          / torch.clamp(d * torch.sqrt(torch.clamp(d, min=1e-12)), min=1e-12))


def sample_phase_hg(w_i, g, rnd2):
  """A direction w_o drawn from the HG phase function around w_i."""
  iso = torch.abs(g) < 1e-3
  cos_iso = 1.0 - 2.0 * rnd2[..., 0]
  g_safe = torch.where(iso, 0.5, g)
  sqr_term = (1.0 - g_safe * g_safe) / (1.0 + g_safe * (2.0 * rnd2[..., 0] - 1.0))
  cos_aniso = (1.0 + g_safe * g_safe - sqr_term * sqr_term) / (2.0 * g_safe)
  cos_theta = torch.where(iso, cos_iso, cos_aniso)
  sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
  phi = em.kDoublePi * rnd2[..., 1]
  u, v = em.orthonormal_basis(w_i)
  return ((u * torch.cos(phi)[..., None] + v * torch.sin(phi)[..., None]) * sin_theta[..., None]
          - w_i * cos_theta[..., None])


def sample_spectrum_component(albedo, throughput, rnd, spectral: bool):
  """Channel-MIS pick: (channel (R,) int64, pdf (R,C)). Spectral mode has
  one channel."""
  r = albedo.shape[0]
  dev = albedo.device
  if spectral:
    return torch.zeros(r, dtype=torch.int64, device=dev), torch.ones((r, 1), device=dev)
  at = albedo * throughput
  s = csum(at)[..., None]
  zero = s[..., 0] <= 0.0
  pdf = torch.where(zero[..., None], 1.0 / 3.0, at / torch.clamp(s, min=1e-20))
  cum0 = pdf[..., 0]
  cum1 = pdf[..., 0] + pdf[..., 1]
  ch = 2 - (rnd < cum1).to(torch.int64) - (rnd < cum0).to(torch.int64)
  ch_zero = torch.clamp((3.0 * rnd).to(torch.int64), max=2)
  return torch.where(zero, ch_zero, ch), pdf


def component(v, channel, spectral: bool):
  """v's entry at each lane's channel."""
  if spectral:
    return v[..., 0]
  return v.gather(-1, channel[..., None])[..., 0]


class MediumView(NamedTuple):
  """Per-ray medium properties gathered from the medium table."""
  cls: torch.Tensor          # (R,) 0 none / 1 homogeneous / 2 heterogeneous
  scattering: torch.Tensor   # (R,C)
  absorption: torch.Tensor   # (R,C)
  phase_g: torch.Tensor      # (R,)
  max_sigma: torch.Tensor    # (R,)
  bounds_min: torch.Tensor   # (R,3)
  bounds_max: torch.Tensor   # (R,3)
  grid_index: torch.Tensor   # (R,) medium row (for grid lookups)
  explicit_connections: torch.Tensor  # (R,) bool

  @property
  def extinction(self):
    return self.scattering + self.absorption

  @property
  def albedo(self):
    ext = self.extinction
    return torch.where(ext > 0.0, self.scattering / torch.clamp(ext, min=1e-20), 0.0)

  @property
  def valid(self):
    return self.cls > 0


def gather_medium(scene, medium_idx, wl, spectral: bool) -> MediumView:
  """The medium rows of `medium_idx` (-1: vacuum, class 0)."""
  m = scene.mediums
  safe = torch.clamp(medium_idx, min=0).to(torch.int64)
  valid = medium_idx >= 0
  scat = spx.query_spd(scene, m.scattering_spec[safe], wl, spectral)
  absorb = spx.query_spd(scene, m.absorption_spec[safe], wl, spectral)
  return MediumView(
      cls=torch.where(valid, m.cls[safe], 0),
      scattering=scat, absorption=absorb,
      phase_g=m.phase_g[safe], max_sigma=m.max_sigma[safe],
      bounds_min=m.bounds_min[safe], bounds_max=m.bounds_max[safe],
      grid_index=safe, explicit_connections=m.explicit_connections[safe] > 0)


def sample_density(scene, mv: MediumView, world_pos):
  """Trilinear density at world_pos in the medium's grid, 0 outside its box.

  The JAX package fetches the four (z, y) corner rows of a small grid as one
  weighted one-hot matmul and interpolates along x by a two-hot sum; this
  gathers the eight corner voxels directly and computes the same arithmetic
  in the same order: the corners weighted by (1-dz)(1-dy), (1-dz)dy,
  dz(1-dy) and dz dy and summed in that order, at x and at x + 1, then
  interpolated along x with (1-dx) and dx."""
  grid = scene.mediums.grid  # (D, gz, gy, gx)
  _, gz, gy, gx = grid.shape
  local = (world_pos - mv.bounds_min) / torch.clamp(mv.bounds_max - mv.bounds_min, min=1e-12)
  inside = ((local >= 0.0) & (local < 1.0)).all(dim=-1)
  px = torch.clamp(local[..., 0] * gx - 0.5, 0.0, gx - 1.0)
  py = torch.clamp(local[..., 1] * gy - 0.5, 0.0, gy - 1.0)
  pz = torch.clamp(local[..., 2] * gz - 0.5, 0.0, gz - 1.0)
  ix = torch.clamp(px.to(torch.int64), max=gx - 1)
  iy = torch.clamp(py.to(torch.int64), max=gy - 1)
  iz = torch.clamp(pz.to(torch.int64), max=gz - 1)
  nx = torch.clamp(ix + 1, max=gx - 1)
  ny = torch.clamp(iy + 1, max=gy - 1)
  nz = torch.clamp(iz + 1, max=gz - 1)
  dx = px - torch.floor(px)
  dy = py - torch.floor(py)
  dz = pz - torch.floor(pz)
  gi = mv.grid_index
  weights = ((1.0 - dz) * (1.0 - dy), (1.0 - dz) * dy, dz * (1.0 - dy), dz * dy)
  corners = ((iz, iy), (iz, ny), (nz, iy), (nz, ny))

  def rows_at(xx):
    out = None
    for w, (zz, yy) in zip(weights, corners):
      term = w * grid[gi, zz, yy, xx]
      out = term if out is None else out + term
    return out

  val = rows_at(ix) * (1.0 - dx) + rows_at(nx) * dx
  return torch.where(inside, val, 0.0)


def bounds_range(mv: MediumView, pos, direction, max_t):
  """Overlap [t_min, t_max] of each ray with its medium's box, and whether
  it is not empty."""
  safe_d = torch.where(torch.abs(direction) < 1e-12,
                       torch.where(direction < 0, -1e-12, 1e-12), direction)
  t0 = (mv.bounds_min - pos) / safe_d
  t1 = (mv.bounds_max - pos) / safe_d
  tlo = torch.minimum(t0, t1)
  thi = torch.maximum(t0, t1)
  t_min = torch.clamp(torch.amax(tlo, dim=-1), min=0.0)
  t_max = torch.minimum(torch.amin(thi, dim=-1), max_t)
  return t_min, t_max, t_min <= t_max


class MediumSample(NamedTuple):
  sampled: torch.Tensor   # (R,) bool: a scattering event inside the medium
  t: torch.Tensor         # (R,) distance to the event
  pos: torch.Tensor       # (R,3) event position
  weight: torch.Tensor    # (R,C) transport weight


def sample_medium(scene, mv: MediumView, wl, throughput, rng_state, pos, w_i, max_t,
                  spectral: bool):
  """Free-path sampling along each ray up to max_t. Returns (MediumSample,
  rng_state). Lanes in vacuum get sampled=False, weight 1."""
  r = pos.shape[0]
  c = spx.channels(spectral)
  dev = pos.device

  # homogeneous: analytic, channel MIS
  rng_state, rnd_ch = rng.next_float(rng_state)
  rng_state, rnd_t = rng.next_float(rng_state)
  ext = mv.extinction
  channel, ch_pdf = sample_spectrum_component(mv.albedo, throughput, rnd_ch, spectral)
  sigma = component(ext, channel, spectral)
  t_h = torch.where(sigma > 0.0,
                    -torch.log(torch.clamp(1.0 - rnd_t, min=1e-10)) / torch.clamp(sigma, min=1e-20),
                    max_t)
  t_h = torch.minimum(torch.clamp(t_h, min=em.kRayEpsilon), max_t)
  sampled_h = t_h < max_t
  tr = torch.exp(-t_h[..., None] * ext)
  pdf_h = torch.where(sampled_h[..., None], ch_pdf * tr * ext, ch_pdf * tr)
  pdf_sum = csum(pdf_h)
  num = torch.where(sampled_h[..., None], tr * mv.scattering, tr)
  weight_h = torch.where((pdf_sum > 0.0)[..., None],
                         num / torch.clamp(pdf_sum, min=1e-30)[..., None], 0.0)

  # heterogeneous: delta tracking
  is_het = mv.cls == 2
  t_lo, t_hi, overlaps = bounds_range(mv, pos, w_i, max_t)
  inv_sigma = 1.0 / torch.clamp(mv.max_sigma, min=1e-20)
  active = is_het & overlaps & (mv.max_sigma > 0.0)
  t = t_lo
  prev_t = t_lo
  scattered = torch.zeros(r, dtype=torch.bool, device=dev)
  acc_tr = torch.ones((r, c), device=dev)
  pdf_het = torch.ones(r, device=dev)
  while bool(active.any().item()):
    rng_state, r1 = rng.next_float(rng_state)
    t_new = t - torch.log(torch.clamp(1.0 - r1, min=1e-10)) * inv_sigma
    exited = t_new >= t_hi
    t_new_clamped = torch.minimum(t_new, t_hi)
    dist = torch.maximum(t_new_clamped, prev_t) - prev_t
    acc_tr = torch.where(active[..., None], acc_tr * torch.exp(-ext * dist[..., None]), acc_tr)
    density = sample_density(scene, mv, pos + w_i * t_new[..., None])
    rng_state, r2 = rng.next_float(rng_state)
    rng_state, r3 = rng.next_float(rng_state)
    ch2, ch_pdf2 = sample_spectrum_component(mv.albedo, mv.scattering, r2, spectral)
    sigma_t = component(ext, ch2, spectral)
    scatter_now = active & ~exited & (sigma_t > 0.0) & (r3 < density)
    pdf_het = torch.where(scatter_now, csum(ch_pdf2), pdf_het)
    scattered = scattered | scatter_now
    active = active & ~exited & ~scatter_now
    moved = active | scatter_now
    prev_t = torch.where(moved, t_new_clamped, prev_t)
    t = torch.where(moved, t_new, t)
  # the tail segment when no scatter happened
  tail = torch.clamp(t_hi - prev_t, min=0.0)
  acc_tr = torch.where(scattered[..., None], acc_tr, acc_tr * torch.exp(-ext * tail[..., None]))
  weight_het = torch.where(scattered[..., None],
                           mv.scattering * acc_tr / torch.clamp(pdf_het, min=1e-20)[..., None],
                           acc_tr)

  is_hom = mv.cls == 1
  sampled = torch.where(is_hom, sampled_h, is_het & scattered)
  t_out = torch.where(is_hom, t_h, t)
  weight = torch.where(is_hom[..., None], weight_h,
                       torch.where(is_het[..., None], weight_het, 1.0))
  return MediumSample(sampled=sampled, t=t_out, pos=pos + w_i * t_out[..., None],
                      weight=weight), rng_state


def transmittance(scene, mv: MediumView, wl, rng_state, pos, direction, distance,
                  spectral: bool):
  """Transmittance over each segment: analytic in a homogeneous medium,
  ratio tracking in a heterogeneous one. Returns (tr (R,C), rng_state)."""
  r = pos.shape[0]
  c = spx.channels(spectral)
  ext = mv.extinction
  tr_hom = torch.exp(-ext * distance[..., None])

  is_het = mv.cls == 2
  t_lo, t_hi, overlaps = bounds_range(mv, pos, direction, distance)
  inv_sigma = 1.0 / torch.clamp(mv.max_sigma, min=1e-20)
  active = is_het & overlaps & (mv.max_sigma > 0.0)
  t = t_lo
  tr_het = torch.ones((r, c), device=pos.device)
  while bool(active.any().item()):
    rng_state, r1 = rng.next_float(rng_state)
    t = t - torch.log(torch.clamp(1.0 - r1, min=1e-10)) * inv_sigma
    exited = t >= t_hi
    density = sample_density(scene, mv, pos + direction * t[..., None])
    tr_het = torch.where((active & ~exited)[..., None],
                         tr_het * torch.clamp(1.0 - density, min=0.0)[..., None], tr_het)
    active = active & ~exited & (torch.amax(tr_het, dim=-1) > 1e-5)

  is_hom = mv.cls == 1
  tr = torch.where(is_hom[..., None], tr_hom, torch.where(is_het[..., None], tr_het, 1.0))
  return tr, rng_state
