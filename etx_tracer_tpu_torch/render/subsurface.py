"""Subsurface scattering: the Burley remap, the random-walk gather and the
Christensen-Burley disk gather.

Counterpart of `etx_tracer_tpu/render/subsurface.py`. The random walk steps
through the object's interior with channel-MIS exponential distances and
isotropic scattering, tracing only the entry material's triangles
(`trace_material`); the Christensen-Burley gather probes three disks of the
entry frame and keeps one same-material exit by weighted reservoir
sampling. The walk (at most 64 steps) and `trace_material`'s skips (at most
4 traces) loop over the whole wavefront while any lane is active, drawing
from every lane's RNG on every step, as the JAX `lax.while_loop`s do; each
iteration reads its condition on the host once. Every trace goes through
`ops/trace.py`'s dispatch, so on the card through the trace kernels; lanes
that are done trace an empty interval (t_max = 0, t_min = kRayEpsilon),
which the kernels answer with a miss.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.core import rng
from etx_tracer_tpu_torch.ops import trace as trace_ops
from etx_tracer_tpu_torch.render import images as images_mod
from etx_tracer_tpu_torch.render import media as media_mod
from etx_tracer_tpu_torch.render import spectral as spx
from etx_tracer_tpu_torch.scene import packed
from etx_tracer_tpu_torch.scene.types import SubsurfaceClass as SC

_MAX_WALK = 64
_MAX_SKIPS = 4
_CB_HITS = 4          # same-material exits collected per probe
_CB_MAX_RADIUS = 47.827155457397595950044717258511


def remap(color, distances):
  """Burley parameter remap of (R,C) colour and mean free paths: (albedo,
  extinction, scattering)."""
  a = 1.826052378200
  b = 4.985111943850 + 0.12735595943800
  c = 1.096861024240
  d = 0.496310210422
  e = 4.231902997010 + 0.00310603949088
  f = 2.406029994080
  k_min = 1.0 / 1024.0

  col = torch.clamp(color, min=0.0)
  blend = torch.pow(col, 0.25)
  albedo = ((1.0 - blend) * a * torch.pow(torch.atan(b * col), c)
            + blend * d * torch.pow(torch.atan(e * col), f))
  albedo = torch.clamp(albedo, 0.0, 1.0 - em.kEpsilon)
  extinction = 1.0 / torch.clamp(distances, min=k_min)
  scattering = extinction * albedo
  return albedo, extinction, scattering


def trace_material(scene, o, d, t_min, t_max, mat_target):
  """Closest hit on triangles of material `mat_target` (R,): a hit on
  another material is stepped past and traced again, at most 4 traces.
  Returns (found, t, u, v, tri)."""
  r = o.shape[0]
  dev = o.device
  cur_o = o
  traveled = torch.zeros(r, device=dev)
  found = torch.zeros(r, dtype=torch.bool, device=dev)
  best_t = torch.full((r,), float("inf"), device=dev)
  best_hit = torch.zeros((r, 3), device=dev)
  best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
  active = torch.ones(r, dtype=torch.bool, device=dev)
  t_eps = torch.full((r,), em.kRayEpsilon, device=dev)
  it = 0
  while it < _MAX_SKIPS and bool(active.any().item()):
    rem = torch.clamp(t_max - traveled, min=0.0)
    hit = trace_ops.trace_closest(scene, cur_o, d, t_eps, torch.where(active, rem, 0.0))
    mat = packed.TriRows(scene.tri_table[torch.clamp(hit.tri, min=0)]).mat
    match = hit.found & (mat == mat_target)
    newly = active & match
    found = found | newly
    best_t = torch.where(newly, traveled + hit.t, best_t)
    best_hit = torch.where(newly[..., None], torch.stack([hit.u, hit.v, hit.t], dim=-1), best_hit)
    best_tri = torch.where(newly, hit.tri, best_tri)
    skip = active & hit.found & ~match
    step = hit.t + 4.0 * em.kRayEpsilon
    cur_o = torch.where(skip[..., None], cur_o + d * step[..., None], cur_o)
    traveled = torch.where(skip, traveled + step, traveled)
    active = skip
    it += 1
  return found, best_t, best_hit[:, 0], best_hit[:, 1], best_tri


class SSSGather(NamedTuple):
  found: torch.Tensor     # (R,) bool
  pos: torch.Tensor       # (R,3) exit position
  nrm: torch.Tensor       # (R,3) exit shading normal
  geo_n: torch.Tensor     # (R,3)
  tan: torch.Tensor
  btn: torch.Tensor
  uv: torch.Tensor        # (R,2)
  tri: torch.Tensor       # (R,) int32
  weight: torch.Tensor    # (R,C) throughput through the medium
  w_i: torch.Tensor       # (R,3) the walk's or probe's direction at the exit


def _exit_from_tri(scene, u, v, tri):
  """Surface attributes of the exit point (u, v) on triangle `tri`."""
  tri_s = torch.clamp(tri, min=0).to(torch.int64)
  trows = packed.TriRows(scene.tri_table[tri_s])
  w0 = (1.0 - u - v)[..., None]
  w1 = u[..., None]
  w2 = v[..., None]
  pos = scene.tri_v0[tri_s] + u[..., None] * scene.tri_e1[tri_s] + v[..., None] * scene.tri_e2[tri_s]
  nrm = em.normalize(trows.n0 * w0 + trows.n1 * w1 + trows.n2 * w2)
  tan = em.normalize(trows.t0 * w0 + trows.t1 * w1 + trows.t2 * w2)
  btn = em.normalize(trows.b0 * w0 + trows.b1 * w1 + trows.b2 * w2)
  uv = trows.uv0 * w0 + trows.uv1 * w1 + trows.uv2 * w2
  return pos, nrm, trows.geo_n, tan, btn, uv


def gather_rw(scene, sd, mat_idx, entry_pos, rng_state, active, spectral: bool):
  """Random-walk SSS from the entry points of the `active` lanes: walk the
  interior of the entry material (`mat_idx`) until a step reaches its
  surface. Returns (SSSGather, rng_state)."""
  r = entry_pos.shape[0]
  c = spx.channels(spectral)
  dev = entry_pos.device

  color = spx.query_spd(scene, sd.mat.scattering_spec, sd.wl, spectral)
  distances = spx.query_spd(scene, sd.mat.subsurface_spec, sd.wl, spectral)
  albedo, extinction, scattering = remap(color, distances)

  # first direction: the cosine lobe below the surface
  rng_state, rnd0 = rng.next_2d(rng_state)
  d = em.sample_cosine_distribution_n(rnd0, -sd.nrm, 1.0)
  o = em.offset_ray(entry_pos,
                    sd.geo_n * torch.where(em.dot(sd.geo_n, d) >= 0, 1.0, -1.0)[..., None])
  thr = torch.ones((r, c), device=dev)
  found = torch.zeros(r, dtype=torch.bool, device=dev)
  exit_data = torch.zeros((r, 6 + c), device=dev)
  walk_active = active
  t_eps = torch.full((r,), em.kRayEpsilon, device=dev)
  zero_g = torch.zeros(r, device=dev)
  it = 0
  while it < _MAX_WALK and bool(walk_active.any().item()):
    rng_state, r_ch = rng.next_float(rng_state)
    channel, ch_pdf = media_mod.sample_spectrum_component(albedo, thr, r_ch, spectral)
    sigma = media_mod.component(extinction, channel, spectral)
    rng_state, r_t = rng.next_float(rng_state)
    max_t = torch.where(sigma > 0.0,
                        -torch.log(torch.clamp(1.0 - r_t, min=1e-10)) / torch.clamp(sigma, min=1e-20),
                        em.kMaxFloat)

    found_i, t_hit, u, v, tri_hit = trace_material(
        scene, o, d, t_eps, torch.where(walk_active, max_t, 0.0), mat_idx)

    seg = torch.where(found_i, t_hit, max_t)
    tr = torch.exp(-seg[..., None] * extinction)
    pdf = ch_pdf * torch.where(found_i[..., None], tr, tr * extinction)
    pdf_sum = media_mod.csum(pdf)
    w = torch.where(found_i[..., None], tr, tr * scattering)
    thr_new = thr * w / torch.clamp(pdf_sum, min=1e-30)[..., None]
    dead = (pdf_sum <= 0.0) | (torch.amax(thr_new, dim=-1) <= em.kEpsilon)

    exited = walk_active & found_i & ~dead
    found = found | exited
    exit_new = torch.cat([u[..., None], v[..., None], tri_hit.to(torch.float32)[..., None],
                          d, thr_new], dim=-1)
    exit_data = torch.where(exited[..., None], exit_new, exit_data)

    # go on: move, and scatter isotropically
    rng_state, rnd_p = rng.next_2d(rng_state)
    new_d = media_mod.sample_phase_hg(d, zero_g, rnd_p)
    o = torch.where(walk_active[..., None], o + d * seg[..., None], o)
    d = torch.where(walk_active[..., None], new_d, d)
    thr = torch.where(walk_active[..., None], thr_new, thr)
    walk_active = walk_active & ~exited & ~dead
    it += 1

  u = exit_data[:, 0]
  v = exit_data[:, 1]
  tri = exit_data[:, 2].to(torch.int32)
  pos, nrm, geo_n, tan, btn, uv = _exit_from_tri(scene, u, v, tri)
  return SSSGather(found=found, pos=pos, nrm=nrm, geo_n=geo_n, tan=tan, btn=btn, uv=uv,
                   tri=tri, weight=exit_data[:, 6:], w_i=exit_data[:, 3:6]), rng_state


def _sample_s_r(rnd):
  """Inverse of the Burley radius CDF."""
  lo = torch.log(1.0 / torch.clamp(1.0 - torch.clamp(4.0 * rnd, max=1.0 - em.kEpsilon),
                                   min=1e-10))
  hi_r = torch.clamp((rnd - 0.25) / 0.75, max=1.0 - em.kEpsilon)
  hi = 3.0 * torch.log(1.0 / torch.clamp(1.0 - hi_r, min=1e-10))
  return torch.where(rnd < 0.25, lo, hi)


def _cb_profile(sd_dist, radius):
  """Christensen-Burley profile at `radius` (R,) for mean free paths (R,C)."""
  radius = torch.clamp(radius, min=em.kEpsilon)[..., None]
  term0 = torch.exp(-radius / (3.0 * torch.clamp(sd_dist, min=1e-8)))
  term1 = term0 * term0 * term0
  div = torch.clamp(sd_dist * (4.0 * radius * 2.0 * em.kPi), min=em.kEpsilon)
  return (term0 + term1) / div


def gather_cb(scene, sd, mat_idx, entry_pos, rng_state, active, spectral: bool):
  """Christensen-Burley gather: three disk probes along the entry frame's
  axes, each taking up to 4 same-material exits weighted by profile/pdf and
  the axis MIS weight; one exit is kept by weighted reservoir sampling and
  carries the RIS weight. Returns (SSSGather, rng_state)."""
  r = entry_pos.shape[0]
  c = spx.channels(spectral)
  dev = entry_pos.device

  sdist = spx.query_spd(scene, sd.mat.subsurface_spec, sd.wl, spectral)
  base_weight = images_mod.apply_rgb_image(
      scene, spx.query_spd(scene, sd.mat.scattering_spec, sd.wl, spectral), sd.mat,
      "scattering_img", sd.tex, sd.wl, spectral)

  frames = [
      (sd.tan, sd.btn, sd.nrm, (0.25, 0.25, 0.5)),
      (sd.btn, sd.nrm, sd.tan, (0.25, 0.5, 0.25)),
      (sd.nrm, sd.tan, sd.btn, (0.5, 0.25, 0.25)),
  ]

  total_w = torch.zeros(r, device=dev)
  sel_w = torch.zeros(r, device=dev)
  sel_weight = torch.zeros((r, c), device=dev)
  sel_exit = torch.zeros((r, 3), device=dev)  # u, v, tri
  sel_wi = torch.zeros((r, 3), device=dev)
  found_any = torch.zeros(r, dtype=torch.bool, device=dev)
  t_eps = torch.full((r,), em.kRayEpsilon, device=dev)

  for fu, fv, fw, (pu, pv, pw) in frames:
    rng_state, r_ch = rng.next_float(rng_state)
    channel = torch.clamp((r_ch * c).to(torch.int64), max=c - 1)
    dist_ch = sdist.gather(-1, channel[..., None])[..., 0]
    rng_state, r_rad = rng.next_float(rng_state)
    radius = dist_ch * _sample_s_r(r_rad)
    r_max = dist_ch * _CB_MAX_RADIUS
    rng_state, r_phi = rng.next_float(rng_state)
    phi = 2.0 * em.kPi * r_phi
    height = torch.sqrt(torch.clamp(em.sqr(r_max) - em.sqr(radius), min=0.0))
    dir_ok = active & (dist_ch > 0.0) & (radius < r_max) & (height > em.kRayEpsilon)

    probe_o = (entry_pos + height[..., None] * fw
               + radius[..., None] * (torch.cos(phi)[..., None] * fu
                                      + torch.sin(phi)[..., None] * fv))
    probe_d = -fw
    remaining = 2.0 * height
    cur_o = probe_o
    traveled = torch.zeros(r, device=dev)
    probe_active = dir_ok
    for _ in range(_CB_HITS):
      f_i, t_hit, u_i, v_i, tri_i = trace_material(
          scene, cur_o, probe_d, t_eps,
          torch.where(probe_active, torch.clamp(remaining - traveled, min=0.0), 0.0), mat_idx)
      got = probe_active & f_i
      pos_i, nrm_i, _, _, _, _ = _exit_from_tri(scene, u_i, v_i, tri_i)

      pdf_t = pu * torch.abs(em.dot(nrm_i, fu))
      pdf_b = pv * torch.abs(em.dot(nrm_i, fv))
      pdf_n = pw * torch.abs(em.dot(nrm_i, fw))
      gw = em.sqr(pdf_n) / torch.clamp(em.sqr(pdf_t) + em.sqr(pdf_b) + em.sqr(pdf_n), min=1e-20)

      pdf = media_mod.csum(_cb_profile(sdist, radius)) / c
      dist = em.length(pos_i - entry_pos)
      ev = _cb_profile(sdist, dist)
      wgt = base_weight * ev / torch.clamp(pdf, min=1e-20)[..., None] * gw[..., None]
      w_avg = media_mod.csum(wgt) / c
      ok = got & (pdf > 0.0) & (w_avg > 0.0)

      total_w = total_w + torch.where(ok, w_avg, 0.0)
      # weighted reservoir: replace the pick with probability w / total
      rng_state, r_pick = rng.next_float(rng_state)
      take = ok & (r_pick * torch.clamp(total_w, min=1e-30) < w_avg)
      sel_w = torch.where(take, w_avg, sel_w)
      sel_weight = torch.where(take[..., None], wgt, sel_weight)
      sel_exit = torch.where(take[..., None],
                             torch.stack([u_i, v_i, tri_i.to(torch.float32)], dim=-1), sel_exit)
      sel_wi = torch.where(take[..., None], probe_d, sel_wi)
      found_any = found_any | ok

      # step past this exit
      step = torch.where(f_i, t_hit, remaining) + 4.0 * em.kRayEpsilon
      cur_o = torch.where(got[..., None], cur_o + probe_d * step[..., None], cur_o)
      traveled = traveled + torch.where(got, step, 0.0)
      probe_active = got & (traveled < remaining)

  tri = sel_exit[:, 2].to(torch.int32)
  pos, nrm, geo_n, tan, btn, uv = _exit_from_tri(scene, sel_exit[:, 0], sel_exit[:, 1], tri)
  ris = total_w / torch.clamp(sel_w, min=1e-30)
  weight = sel_weight * ris[..., None]
  return SSSGather(found=found_any, pos=pos, nrm=nrm, geo_n=geo_n, tan=tan, btn=btn, uv=uv,
                   tri=tri, weight=torch.where(found_any[..., None], weight, 0.0),
                   w_i=sel_wi), rng_state


def gather(scene, sd, mat_idx, entry_pos, rng_state, active, spectral: bool,
           subsurface_classes=(SC.RandomWalk,)):
  """The gather of each lane's subsurface class; `subsurface_classes` is the
  scene's set (`SceneConfig.subsurface_classes`): with both, both gathers
  run, each on its own lanes, random walk first."""
  has_rw = SC.RandomWalk in subsurface_classes
  has_cb = SC.ChristensenBurley in subsurface_classes
  if has_cb and not has_rw:
    return gather_cb(scene, sd, mat_idx, entry_pos, rng_state, active, spectral)
  if has_rw and not has_cb:
    return gather_rw(scene, sd, mat_idx, entry_pos, rng_state, active, spectral)
  is_cb = sd.mat.subsurface_cls == SC.ChristensenBurley
  g_rw, rng_state = gather_rw(scene, sd, mat_idx, entry_pos, rng_state, active & ~is_cb,
                              spectral)
  g_cb, rng_state = gather_cb(scene, sd, mat_idx, entry_pos, rng_state, active & is_cb,
                              spectral)
  return SSSGather(*(torch.where(is_cb if a.dim() == 1 else is_cb[..., None], a, b)
                     for a, b in zip(g_cb, g_rw))), rng_state
