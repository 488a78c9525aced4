"""Wavefront unidirectional path tracer with NEE + MIS: the pooled renderer.

Counterpart of `etx_tracer_tpu/models/path_tracing.py`'s main path:
`render` -> `render_samples_static` (a fixed lane pool with static
lane -> pixel ownership, run as a cascade of ever narrower phases) ->
`pt_step`. Scenes without media or a radiance clamp take `pt_step` with
deferred next-event estimation (each step's shadow ray is traced in the
NEXT step, beside the path rays): every bounce makes two trace launches,
the closest-hit kernel for path rays and the any-hit kernel for last step's
shadow rays, and each phase ends with one more any-hit launch that drains
the pending shadow rays. Scenes with media or a clamp take the non-deferred
form, as the JAX package does: a step traces its own shadow rays, through
`_trace_transmittance` (up to 16 closest-hit traces a ray, Boundary
interfaces switching the medium) with media, else through the any-hit
kernel; there are no pending rays and no drain.

The port renders every material class (`config.material_classes`; the
Diffuse variations of `config.diffuse_variations`), with material images
(colours, roughness, metalness, transmission, normal maps) and the
stochastic alpha test (`config.has_alpha`: a hit is skipped, the lane going
straight on, with probability one minus the opacity times the scattering
image's alpha), lit by area emitters and distant ones
(environment maps and directional sun disks: NEE samples every class of
`config.emitter_classes`, a missed ray gathers the environment through
`emitters.env_contribution`), seen through a pinhole, a thin lens or an
equirectangular camera, in RGB or spectral mode (one sampled wavelength
per lane; a bounce evaluates the spectrum bank at each lane's wavelength
once), with homogeneous and
heterogeneous media (free-path sampling, NEE from medium points with HG
phase MIS, `render/media.py`), subsurface scattering (random walk and
Christensen-Burley, `render/subsurface.py`) and a radiance clamp on each
sample. With `config.blue_noise` the first bounce's BSDF and emitter draws
take blue-noise-rotated R2 points (`core/bluenoise.py`) in place of the
stream's. RNG streams key off (pixel, iteration) only, so
the port reproduces the JAX package's sample streams draw for draw; the
media and subsurface loops run over the whole wavefront for the JAX loops'
trip counts, which every lane's stream depends on.

PyTorch runs eagerly, so the JAX `while_loop`s are Python loops; the pool
loop reads its condition on the host once per 4 steps, as the JAX loop body
runs 4 steps between two tests of its condition, and the loops inside a
bounce once per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from etx_tracer_tpu_torch import resolve_device
from etx_tracer_tpu_torch.core import bluenoise
from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.core import rng
from etx_tracer_tpu_torch.core import spectrum as spmod
from etx_tracer_tpu_torch.ops import trace as trace_ops
from etx_tracer_tpu_torch.render import camera as camera_mod
from etx_tracer_tpu_torch.render import emitters as emitters_mod
from etx_tracer_tpu_torch.render import film as film_mod
from etx_tracer_tpu_torch.render import images as images_mod
from etx_tracer_tpu_torch.render import media as media_mod
from etx_tracer_tpu_torch.render import spectral as spx
from etx_tracer_tpu_torch.render import subsurface as sss_mod
from etx_tracer_tpu_torch.render.bsdf import dispatch as bsdf_dispatch
from etx_tracer_tpu_torch.render.bsdf.lobes import ShadingData
from etx_tracer_tpu_torch.scene import packed
from etx_tracer_tpu_torch.scene import types as st
from etx_tracer_tpu_torch.scene.types import MaterialClass as MC
from etx_tracer_tpu_torch.scene.types import SubsurfaceClass
from etx_tracer_tpu_torch.utils import validate

# closest-hit traces a shadow segment may take through Boundary interfaces
_MAX_SEGMENTS = 16


class PTState(NamedTuple):
  """SoA wavefront payload, one row per lane."""
  ray_o: torch.Tensor        # (R,3)
  ray_d: torch.Tensor        # (R,3)
  t_min: torch.Tensor        # (R,)
  t_max: torch.Tensor        # (R,)
  throughput: torch.Tensor   # (R,C)
  accumulated: torch.Tensor  # (R,C)
  view_normal: torch.Tensor  # (R,3)
  view_albedo: torch.Tensor  # (R,C)
  medium: torch.Tensor       # (R,) int32 medium the ray travels in, -1: vacuum
  path_length: torch.Tensor  # (R,) int32
  eta: torch.Tensor          # (R,)
  bsdf_pdf: torch.Tensor     # (R,)
  mis_flag: torch.Tensor     # (R,) bool
  rng_state: torch.Tensor    # (R,) int64 holding a uint32
  wl: torch.Tensor           # (R,) wavelength (spectral mode), else 0
  alive: torch.Tensor        # (R,) bool
  pixel: torch.Tensor        # (R,) int64 film pixel this lane renders
  sample_iter: torch.Tensor  # (R,) int64 sample iteration of this lane
  rays_traced: torch.Tensor  # () int64: path rays + shadow rays traced
  # deferred-NEE pending shadow ray, traced in the NEXT step; tmax < 0 = none
  # (without deferred NEE these ride along unchanged)
  psh_o: torch.Tensor        # (R,3)
  psh_d: torch.Tensor        # (R,3)
  psh_tmax: torch.Tensor     # (R,)
  psh_rgb: torch.Tensor      # (R,3) film-RGB contribution if unoccluded
  res_rgb: torch.Tensor      # (R,3) resolved contribution of LAST step's ray
  res_valid: torch.Tensor    # (R,) bool


def make_lane_payload(scene, config, sample_ids: torch.Tensor, end_sample: int,
                      lens: camera_mod.Lens | None = None, row_offset: int = 0,
                      full_height: int | None = None) -> PTState:
  """Per-lane payload for sample ids; id s is pixel s % (W*H) at iteration
  s // (W*H). Lanes with s >= end_sample start dead. The RNG is seeded with
  tea(pixel, iteration) and draws, in order: the wavelength (unused in RGB
  mode), the pixel jitter, the lens sample (unused by a pinhole). `lens`
  (`camera.lens_of`) is read from the scene when not given.

  row_offset/full_height: when the film is a band of rows of a larger film
  (the sharded renderer, `parallel/mesh.py`), the pixel ids that seed the
  RNG and place the camera ray are the full film's (local id + row_offset
  * W) and the camera UV maps over `full_height` rows, so a band renders
  exactly the lanes of the single-device render."""
  w, h = config.film_width, config.film_height
  if full_height is None:
    full_height = h
  npix = w * h
  r = sample_ids.shape[0]
  dev = sample_ids.device
  pixel_index = sample_ids % npix + row_offset * w
  iteration = sample_ids // npix
  state = rng.seed(pixel_index, iteration)
  state, wl_rnd = rng.next_float(state)
  if config.spectral:
    wl = spmod.sample_wavelength(wl_rnd)
  else:
    wl = torch.zeros(r, device=dev)
  px = pixel_index % w
  py = pixel_index // w
  state, jit_rnd = rng.next_2d(state)
  jitter = camera_mod.pixel_jitter(config.pixel_filter, jit_rnd, iteration)
  uv = camera_mod.film_uv(px, py, w, full_height, jitter)
  state, lens_rnd = rng.next_2d(state)
  if lens is None:
    lens = camera_mod.lens_of(scene.camera)
  rays = camera_mod.generate_ray(scene.camera, uv, lens_rnd, lens, scene.images,
                                 config.equirectangular)
  c = spx.channels(config.spectral)

  def zeros(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=dev)

  return PTState(
      ray_o=rays.o, ray_d=rays.d, t_min=rays.t_min, t_max=rays.t_max,
      throughput=torch.ones((r, c), device=dev), accumulated=zeros(r, c),
      view_normal=zeros(r, 3), view_albedo=zeros(r, c),
      medium=scene.camera.medium_index.to(torch.int32).expand(r).contiguous(),
      path_length=torch.ones(r, dtype=torch.int32, device=dev),
      eta=torch.ones(r, device=dev), bsdf_pdf=zeros(r),
      mis_flag=torch.ones(r, dtype=torch.bool, device=dev),
      rng_state=state, wl=wl, alive=sample_ids < end_sample,
      pixel=pixel_index, sample_iter=iteration,
      rays_traced=zeros(dtype=torch.int64),
      psh_o=zeros(r, 3), psh_d=zeros(r, 3),
      psh_tmax=torch.full((r,), -1.0, device=dev), psh_rgb=zeros(r, 3),
      res_rgb=zeros(r, 3), res_valid=zeros(r, dtype=torch.bool))


def _interpolate_hit(scene, hit):
  """Surface attributes at each hit (no normal mapping): position, shading
  frame, uv, barycentrics, triangle and its shading row."""
  tri = torch.clamp(hit.tri, min=0)
  bc = em.barycentrics(hit.u, hit.v)
  rows = packed.TriRows(scene.tri_table[tri])
  w0, w1, w2 = bc[..., 0:1], bc[..., 1:2], bc[..., 2:3]
  pos = (scene.tri_v0[tri] + hit.u[..., None] * scene.tri_e1[tri]
         + hit.v[..., None] * scene.tri_e2[tri])
  nrm = em.normalize(rows.n0 * w0 + rows.n1 * w1 + rows.n2 * w2)
  tan = rows.t0 * w0 + rows.t1 * w1 + rows.t2 * w2
  tan = em.normalize(tan - em.dot(tan, nrm)[..., None] * nrm)
  btn_ref = rows.b0 * w0 + rows.b1 * w1 + rows.b2 * w2
  btn = em.cross(nrm, tan)
  btn = em.normalize(btn * torch.where(em.dot(btn, btn_ref) > 0.0, 1.0, -1.0)[..., None])
  uv = rows.uv0 * w0 + rows.uv1 * w1 + rows.uv2 * w2
  return pos, nrm, tan, btn, uv, bc, tri, rows


def _shading_pos(geo_n, geo_pos, w_o):
  """Self-intersection-safe continuation origin: offset along the geometric
  normal toward the outgoing side."""
  side = torch.where(em.dot(geo_n, w_o) >= 0.0, 1.0, -1.0)[..., None]
  return em.offset_ray(geo_pos, geo_n * side)


def _random_continue(path_length, rr_start: int, eta, rnd, throughput):
  """Russian roulette. Returns (continue?, throughput)."""
  max_t = torch.amax(throughput, dim=-1) * em.sqr(eta)
  q = torch.clamp(max_t, max=0.95)
  before_start = path_length < rr_start
  cont = before_start | ((q > 0.0) & (rnd < q))
  scale = torch.where(before_start | (q <= 0.0), 1.0, 1.0 / torch.clamp(q, min=1e-9))
  thr = throughput * scale[..., None]
  nonzero = torch.amax(throughput, dim=-1) > 0.0
  return cont & nonzero, thr


def uses_deferred_nee(config) -> bool:
  """Whether the bounce defers its shadow ray to the next step (no media,
  whose transmittance needs its own walk, and no radiance clamp, which
  caps each sample's total)."""
  return not config.has_media and not config.has_radiance_clamp


def _trace_transmittance(scene, rng_state, medium, from_pos, to_pos, wl, spectral: bool):
  """Transmittance (R,C) of each shadow segment from_pos -> to_pos starting
  in `medium`, and the RNG state. Up to 16 closest-hit traces walk the
  segment over the whole wavefront while any lane is active: a Boundary
  hit switches the medium by the side it is crossed from and the walk goes
  on, any other hit blocks the segment; each piece multiplies in its
  medium's transmittance (`media.transmittance`, which draws from every
  lane's RNG on each of its steps)."""
  r = from_pos.shape[0]
  dev = from_pos.device
  direction = em.normalize(to_pos - from_pos)
  total_dist = em.length(to_pos - from_pos)
  cur = from_pos
  traveled = torch.zeros(r, device=dev)
  med = medium
  tr = torch.ones((r, spx.channels(spectral)), device=dev)
  active = torch.ones(r, dtype=torch.bool, device=dev)
  t_eps = torch.full((r,), em.kRayEpsilon, device=dev)
  it = 0
  while it < _MAX_SEGMENTS and bool(active.any().item()):
    remaining = torch.clamp(total_dist - traveled, min=0.0)
    seg_max = torch.where(active, remaining * (1.0 - 1e-3), 0.0)
    hit = trace_ops.trace_closest(scene, cur, direction, t_eps, seg_max)
    seg_len = torch.where(hit.found, hit.t, remaining)

    mv = media_mod.gather_medium(scene, med, wl, spectral)
    seg_tr, rng_state = media_mod.transmittance(
        scene, mv, wl, rng_state, cur, direction, torch.where(active, seg_len, 0.0), spectral)
    tr = torch.where(active[..., None], tr * seg_tr, tr)

    trows = packed.TriRows(scene.tri_table[torch.clamp(hit.tri, min=0)])
    mat = packed.MaterialRows(scene.mat_table[trows.mat])
    is_boundary = hit.found & (mat.cls == MC.Boundary)
    blocked = hit.found & ~is_boundary
    tr = torch.where((active & blocked)[..., None], 0.0, tr)

    # a boundary: switch the medium by the side it is crossed from, go on
    cross = active & is_boundary
    cos_n = em.dot(trows.geo_n, direction)
    med = torch.where(cross, torch.where(cos_n < 0.0, mat.int_medium, mat.ext_medium), med)
    side = torch.where(cos_n >= 0, 1.0, -1.0)[..., None]
    cur = torch.where(cross[..., None],
                      em.offset_ray(cur + direction * hit.t[..., None], trows.geo_n * side), cur)
    traveled = torch.where(cross, traveled + hit.t, traveled)
    active = cross
    it += 1
  return tr, rng_state


def pt_step(scene, config, state: PTState, deferred: bool | None = None) -> PTState:
  """One wavefront bounce. With `deferred` (default: `uses_deferred_nee`,
  no media and no radiance clamp; the per-iteration, scatter-pool and
  mapped drivers pass False, as their JAX counterparts take the JAX
  `pt_step`'s default) the NEE is deferred: this step's path rays and the
  previous step's shadow rays are traced, the resolved contribution is
  reported via res_rgb/res_valid and this step's shadow ray becomes the new
  pending one. Otherwise each step traces its own shadow rays (through
  `_trace_transmittance` with media, else the any-hit trace) and adds their
  contribution to `accumulated`; with media a lane may scatter in its
  medium before it reaches a surface (NEE from the medium point, then a
  phase-sampled continuation), Boundary hits pass straight through into the
  medium on the far side, and subsurface materials walk to an exit first."""
  r = state.ray_o.shape[0]
  dev = state.ray_o.device
  spectral = config.spectral
  classes = config.material_classes
  if deferred is None:
    deferred = uses_deferred_nee(config)
  if spectral:
    # every SPD at each lane's wavelength, once per bounce: the queries of
    # this bounce at state.wl read it instead of the bank
    scene = scene._replace(spec_at_wl=(state.wl, spmod.bank_at_wl(scene.spec_values, state.wl)))

  # dead lanes trace a degenerate interval
  t_max = torch.where(state.alive, state.t_max, 0.0)
  hit = trace_ops.trace_closest(scene, state.ray_o, state.ray_d, state.t_min, t_max)
  if deferred:
    sh_found = trace_ops.trace_occluded(
        scene, state.psh_o, state.psh_d, torch.full((r,), em.kRayEpsilon, device=dev),
        torch.clamp(state.psh_tmax, min=0.0))
    res_valid = (state.psh_tmax > 0.0) & ~sh_found
    res_rgb = torch.where(res_valid[..., None], state.psh_rgb, 0.0)
  else:
    res_valid = torch.zeros(r, dtype=torch.bool, device=dev)
    res_rgb = torch.zeros((r, 3), device=dev)
  found = hit.found & state.alive

  rng_state = state.rng_state
  accumulated = state.accumulated
  throughput = state.throughput

  # ------------------------------------------------------ medium free path
  if config.has_media:
    mv = media_mod.gather_medium(scene, state.medium, state.wl, spectral)
    seg_t = torch.where(found, hit.t, 2.0 * scene.bsphere_radius * 100.0)
    seg_t = torch.where(state.alive & mv.valid, seg_t, 0.0)
    msample, rng_state = media_mod.sample_medium(
        scene, mv, state.wl, throughput, rng_state, state.ray_o, state.ray_d,
        torch.clamp(seg_t, min=em.kRayEpsilon), spectral)
    in_medium = state.alive & mv.valid & (seg_t > 0.0)
    throughput = torch.where(in_medium[..., None], throughput * msample.weight, throughput)
    medium_event = in_medium & msample.sampled

    # NEE from the medium point, MIS against the phase function
    rng_state, m_rnd_sel = rng.next_float(rng_state)
    rng_state, m_rnd_em = rng.next_2d(rng_state)
    m_em_idx, _ = emitters_mod.sample_emitter_index(scene, m_rnd_sel)
    m_esmp = emitters_mod.sample_emitter(scene, m_em_idx, m_rnd_em, msample.pos, state.wl,
                                         spectral, config.emitter_classes)
    m_tr, rng_state = _trace_transmittance(scene, rng_state, state.medium, msample.pos,
                                           m_esmp.origin, state.wl, spectral)
    phase = media_mod.phase_hg(state.ray_d, m_esmp.direction, mv.phase_g)
    m_w = torch.where(m_esmp.is_delta, 1.0,
                      em.power_heuristic(m_esmp.pdf_dir * m_esmp.pdf_sample, phase))
    m_denom = m_esmp.pdf_dir * m_esmp.pdf_sample
    m_ok = (medium_event & mv.explicit_connections & (m_denom > 0.0)
            & (state.path_length + 1 <= config.max_path_length))
    m_contrib = (m_esmp.value * m_tr
                 * (phase * m_w / torch.clamp(m_denom, min=1e-20))[..., None])
    accumulated = accumulated + torch.where(m_ok[..., None], throughput * m_contrib, 0.0)

    # phase-function continuation
    rng_state, m_rnd_phase = rng.next_2d(rng_state)
    phase_dir = media_mod.sample_phase_hg(state.ray_d, mv.phase_g, m_rnd_phase)
    phase_pdf = media_mod.phase_hg(state.ray_d, phase_dir, mv.phase_g)

    # lanes with a medium event skip the surface this step
    found = found & ~medium_event

  # ---------------------------------------------------------------- miss
  if config.num_env_emitters > 0:
    env = emitters_mod.env_contribution(scene, state.ray_d, state.wl, state.path_length == 1,
                                        state.mis_flag, state.bsdf_pdf,
                                        config.num_env_emitters, spectral)
    miss = state.alive & ~hit.found
    if config.has_media:
      miss = miss & ~medium_event
    accumulated = accumulated + torch.where(miss[..., None], throughput * env, 0.0)

  # ----------------------------------------------------------------- hit
  pos, nrm, tan, btn, uv, _, _, trows = _interpolate_hit(scene, hit)
  mat_idx = trows.mat
  mat = packed.MaterialRows(scene.mat_table[mat_idx])
  emitter_idx = torch.where(found, trows.emitter, -1)
  sd = ShadingData(w_i=state.ray_d, nrm=nrm, tan=tan, btn=btn, geo_n=trows.geo_n,
                   tex=uv, wl=state.wl, medium=state.medium, mat=mat)
  sd = images_mod.apply_normal_map(scene, sd, trows.geo_n)
  nrm = sd.nrm

  # Boundary materials and hits that fail the alpha test pass straight
  # through (a Boundary into the medium on the far side)
  has_boundary = MC.Boundary in classes
  is_boundary = found & (mat.cls == MC.Boundary) if has_boundary else None
  pass_through = is_boundary
  if config.has_alpha:
    # the hit is skipped with probability 1 - opacity x the scattering
    # image's alpha; never a Boundary or a Void hit
    rng_state, a_rnd = rng.next_float(rng_state)
    alpha_v = images_mod.apply_scalar_image(scene, mat.opacity, mat, "scattering_img", uv,
                                            channel=3)
    alpha_skip = found & (mat.cls != MC.Void) & (alpha_v <= a_rnd)
    if has_boundary:
      alpha_skip = alpha_skip & ~is_boundary
    pass_through = alpha_skip if pass_through is None else pass_through | alpha_skip
  surface = found & ~pass_through if pass_through is not None else found

  # --- direct emitter hit ---
  directly_visible = state.path_length == 1
  e_value, _, e_pdf_dir, _ = emitters_mod.area_radiance(
      scene, emitter_idx, state.ray_o, pos, directly_visible, state.wl, spectral)
  e_discrete = emitters_mod.discrete_pdf(scene, torch.clamp(emitter_idx, min=0))
  no_weight = directly_visible | ~state.mis_flag
  mis_w = torch.where(no_weight, 1.0,
                      em.power_heuristic(state.bsdf_pdf, e_discrete * e_pdf_dir))
  direct_ok = surface & (e_pdf_dir > 0.0)
  accumulated = accumulated + torch.where(
      direct_ok[..., None], throughput * e_value * mis_w[..., None], 0.0)
  if config.validate:
    fmask = found[..., None]
    validate.check_finite("pt:direct_emitter", accumulated=accumulated,
                          emitter_value=torch.where(fmask, e_value, 0.0),
                          hit_pos=torch.where(fmask, pos, 0.0),
                          hit_nrm=torch.where(fmask, nrm, 0.0))

  # --- first-hit AOVs ---
  albedo_here = bsdf_dispatch.albedo(scene, sd, spectral)
  first = (found & directly_visible)[..., None]
  view_normal = torch.where(first, nrm, state.view_normal)
  view_albedo = torch.where(first, albedo_here, state.view_albedo)

  # --- BSDF sample ---
  rng_state, rnd_bsdf = rng.next_n(rng_state, bsdf_dispatch.NUM_SAMPLE_RND)
  if config.blue_noise:
    first_b = (state.path_length == 1)[..., None]
    bn = _blue_noise(config, state, 0)
    rnd_bsdf = torch.cat([torch.where(first_b, bn, rnd_bsdf[:, 0:2]), rnd_bsdf[:, 2:]], dim=-1)
  bs = bsdf_dispatch.sample(scene, sd, rnd_bsdf, spectral, classes, config.diffuse_variations)
  if config.validate:
    fmask = found[..., None]
    validate.check_finite("pt:bsdf_sample", weight=torch.where(fmask, bs.weight, 0.0),
                          pdf=torch.where(found, bs.pdf, 0.0),
                          w_o=torch.where(fmask, bs.w_o, 0.0))

  # --- subsurface: walk to an exit, continue and shade from there ---
  if config.has_subsurface:
    sss_path = (found & (mat.subsurface_cls != SubsurfaceClass.Disabled)
                & bs.is_reflection & bs.is_diffuse)
    gather, rng_state = sss_mod.gather(scene, sd, mat_idx, pos, rng_state, sss_path, spectral,
                                       config.subsurface_classes)
    sss_ok = sss_path & gather.found
    ok3 = sss_ok[..., None]
    out_nrm = gather.nrm
    pos = torch.where(ok3, gather.pos, pos)
    nrm = torch.where(ok3, out_nrm, nrm)
    sd = sd._replace(nrm=torch.where(ok3, out_nrm, sd.nrm),
                     tan=torch.where(ok3, gather.tan, sd.tan),
                     btn=torch.where(ok3, gather.btn, sd.btn),
                     geo_n=torch.where(ok3, gather.geo_n, sd.geo_n),
                     tex=torch.where(ok3, gather.uv, sd.tex))
    # the continuation: the cosine lobe at the exit
    rng_state, sss_rnd = rng.next_2d(rng_state)
    sss_dir = em.sample_cosine_distribution_n(sss_rnd, out_nrm, 1.0)
    sss_pdf = torch.abs(em.dot(sss_dir, out_nrm)) * em.kInvPi
    bs = bs._replace(w_o=torch.where(ok3, sss_dir, bs.w_o),
                     weight=torch.where(ok3, gather.weight, bs.weight),
                     pdf=torch.where(sss_ok, sss_pdf, bs.pdf),
                     is_delta=torch.where(sss_ok, False, bs.is_delta))
    # lanes that took the subsurface path but found no exit die
    found = found & ~(sss_path & ~gather.found)
    surface = found & ~pass_through if pass_through is not None else found

  # --- NEE ---
  rng_state, rnd_sel = rng.next_float(rng_state)
  rng_state, rnd_em = rng.next_2d(rng_state)
  if config.blue_noise:
    rnd_em = torch.where(first_b, _blue_noise(config, state, 2), rnd_em)
  can_nee = surface & (state.path_length + 1 <= config.max_path_length)
  em_idx, _ = emitters_mod.sample_emitter_index(scene, rnd_sel)
  esmp = emitters_mod.sample_emitter(scene, em_idx, rnd_em, pos, state.wl, spectral,
                                     config.emitter_classes)
  bsdf_val, bsdf_pdf_at = bsdf_dispatch.evaluate(scene, sd, esmp.direction, spectral, classes,
                                                 config.diffuse_variations)
  if config.has_subsurface:
    # a subsurface exit shades as white diffuse, times the gather's weight
    white = em.kInvPi * torch.clamp(em.dot(sd.nrm, esmp.direction), min=0.0)
    bsdf_val = torch.where(sss_ok[..., None], white[..., None] * gather.weight, bsdf_val)
    bsdf_pdf_at = torch.where(sss_ok, white, bsdf_pdf_at)
  sh_o = _shading_pos(sd.geo_n, pos, esmp.direction)
  w_mis = torch.where(esmp.is_delta, 1.0,
                      em.power_heuristic(esmp.pdf_dir * esmp.pdf_sample, bsdf_pdf_at))
  denom = esmp.pdf_dir * esmp.pdf_sample
  if deferred:
    # this step's shadow ray becomes the pending one
    dist = em.length(esmp.origin - sh_o)
    contrib = bsdf_val * esmp.value * (w_mis / torch.clamp(denom, min=1e-20))[..., None]
    nee_ok = can_nee & (denom > 0.0) & (bsdf_pdf_at > 0.0)
    pend_rgb = spx.to_film_rgb(throughput * contrib, state.wl, spectral)
    psh_o, psh_d = sh_o, esmp.direction
    psh_tmax = torch.where(nee_ok, torch.clamp(dist * (1.0 - 1e-3), min=0.0), -1.0)
    psh_rgb = torch.where(nee_ok[..., None], pend_rgb, 0.0)
  else:
    value = bsdf_val * esmp.value
    if config.has_media:
      # transmittance through Boundary interfaces and media
      tr_nee, rng_state = _trace_transmittance(scene, rng_state, state.medium, sh_o,
                                               esmp.origin, state.wl, spectral)
      vis_ok = torch.amax(tr_nee, dim=-1) > 0.0
      value = value * tr_nee
    else:
      dist = em.length(esmp.origin - sh_o)
      vis_ok = ~trace_ops.trace_occluded(
          scene, sh_o, esmp.direction, torch.full((r,), em.kRayEpsilon, device=dev),
          torch.clamp(dist * (1.0 - 1e-3), min=0.0))
    contrib = value * (w_mis / torch.clamp(denom, min=1e-20))[..., None]
    nee_ok = can_nee & (denom > 0.0) & vis_ok & (bsdf_pdf_at > 0.0)
    accumulated = accumulated + torch.where(nee_ok[..., None], throughput * contrib, 0.0)
    psh_o, psh_d, psh_rgb = state.psh_o, state.psh_d, state.psh_rgb
    psh_tmax = torch.full((r,), -1.0, device=dev)

  # --- continuation ---
  new_d = bs.w_o
  new_throughput = throughput * bs.weight
  new_medium = bs.medium
  new_bsdf_pdf = bs.pdf
  new_mis = ~bs.is_delta
  new_eta = state.eta * bs.eta
  new_len = state.path_length + 1
  continue_ok = found
  sample_ok = bs.pdf > 0.0
  if pass_through is not None:
    # straight through: a Boundary into the medium on the far side, a
    # skipped alpha hit in the same medium
    p3 = pass_through[..., None]
    new_d = torch.where(p3, state.ray_d, new_d)
    new_throughput = torch.where(p3, throughput, new_throughput)
    through_medium = state.medium
    if has_boundary:
      ent = em.dot(nrm, state.ray_d) < 0.0
      crossed = torch.where(ent, mat.int_medium, mat.ext_medium)
      through_medium = torch.where(is_boundary, crossed, through_medium)
    new_medium = torch.where(pass_through, through_medium, new_medium)
    new_bsdf_pdf = torch.where(pass_through, state.bsdf_pdf, new_bsdf_pdf)
    new_mis = torch.where(pass_through, state.mis_flag, new_mis)
    new_eta = torch.where(pass_through, state.eta, new_eta)
    new_len = torch.where(pass_through, state.path_length, new_len)
    sample_ok = pass_through | sample_ok
  new_o = _shading_pos(sd.geo_n, pos, new_d)
  if config.has_media:
    # medium-scatter lanes go on along the sampled phase direction
    me = medium_event
    new_d = torch.where(me[..., None], phase_dir, new_d)
    new_o = torch.where(me[..., None], msample.pos, new_o)
    new_medium = torch.where(me, state.medium, new_medium)
    new_bsdf_pdf = torch.where(me, phase_pdf, new_bsdf_pdf)
    # no NEE competitor where the medium forbids explicit connections: the
    # next direct emitter hit then carries full weight
    new_mis = torch.where(me, mv.explicit_connections, new_mis)
    new_eta = torch.where(me, state.eta, new_eta)
    new_len = torch.where(me, state.path_length + 1, new_len)
    continue_ok = continue_ok | me
    sample_ok = sample_ok | me

  # Russian roulette (not for a boundary pass-through)
  rng_state, rr_rnd = rng.next_float(rng_state)
  cont, new_throughput = _random_continue(new_len, config.rr_start, new_eta, rr_rnd,
                                          new_throughput)
  if pass_through is not None:
    cont = cont | pass_through
  alive = continue_ok & cont & sample_ok & (new_len <= config.max_path_length)
  rays_traced = state.rays_traced + state.alive.sum() + nee_ok.sum()
  if config.validate:
    amask = alive[..., None]
    validate.check_finite("pt:nee", accumulated=accumulated)
    validate.check_finite("pt:continuation",
                          throughput=torch.where(amask, new_throughput, 0.0),
                          ray_o=torch.where(amask, new_o, 0.0),
                          ray_d=torch.where(amask, new_d, 0.0))

  return PTState(
      ray_o=new_o, ray_d=new_d,
      t_min=torch.full((r,), em.kRayEpsilon, device=dev),
      t_max=torch.full((r,), em.kMaxFloat, device=dev),
      throughput=new_throughput, accumulated=accumulated,
      view_normal=view_normal, view_albedo=view_albedo, medium=new_medium,
      path_length=new_len, eta=new_eta, bsdf_pdf=new_bsdf_pdf, mis_flag=new_mis,
      rng_state=rng_state, wl=state.wl, alive=alive, pixel=state.pixel,
      sample_iter=state.sample_iter,
      rays_traced=rays_traced,
      psh_o=psh_o, psh_d=psh_d, psh_tmax=psh_tmax, psh_rgb=psh_rgb,
      res_rgb=res_rgb, res_valid=res_valid)


def _blue_noise(config, state: PTState, dimension: int) -> torch.Tensor:
  """The lanes' blue-noise points of dimension `dimension` (0: the BSDF
  draw, 2: the emitter draw) at their pixel and sample iteration."""
  return bluenoise.sample_2d(state.pixel % config.film_width, state.pixel // config.film_width,
                             state.sample_iter, dimension)


def _lane_color(scene, config, state: PTState) -> torch.Tensor:
  """A lane's radiance as film RGB; with a radiance clamp, a sample past
  its first bounce whose luminance exceeds the clamp is scaled down to it."""
  color = spx.to_film_rgb(state.accumulated, state.wl, config.spectral)
  if not config.has_radiance_clamp:
    return color
  lum = em.luminance(color)
  clamp = scene.radiance_clamp
  scale = torch.where((clamp > 0.0) & (lum > clamp) & (state.path_length > 1),
                      clamp / torch.clamp(lum, min=1e-9), 1.0)
  return color * scale[..., None]


# ---------------------------------------------------------------------------
# Pooled renderer with static lane -> pixel ownership.
# ---------------------------------------------------------------------------


class FilmSums(NamedTuple):
  """Flat per-pixel accumulation table.

  Columns: cam(3), nrm(3), alb(3), var(3), count(1), var_count(1) = 14.
  """
  table: torch.Tensor  # (H*W, 14)

  @property
  def cam_sum(self):
    return self.table[:, 0:3]

  @property
  def nrm_sum(self):
    return self.table[:, 3:6]

  @property
  def alb_sum(self):
    return self.table[:, 6:9]

  @property
  def var_sum(self):
    return self.table[:, 9:12]

  @property
  def count(self):
    return self.table[:, 12]

  @property
  def var_count(self):
    return self.table[:, 13]


_SUMS_WIDTH = 14
# lanes of a pool unless the caller says: the main path's 2^18 (the JAX
# package's drivers default to 2^17, sized for the TPU); a sample's stream
# keys off its pixel and iteration only, so the pool sets the float order of
# a pixel's sums and the number of steps, not the samples
POOL_SIZE = 1 << 18
# pt_steps between two host reads of the loop condition (as the JAX loop
# body runs 4 steps between two tests of its condition)
_UNROLL = 4


def _pick(regen: torch.Tensor, fresh: PTState, old: PTState) -> PTState:
  """Per lane, the fresh payload where regen is set, else the old one
  (scalars keep the old value)."""
  out = []
  for f, o in zip(fresh, old):
    if o.dim() == 0:
      out.append(o)
    else:
      m = regen if o.dim() == 1 else regen[..., None]
      out.append(torch.where(m, f, o))
  return PTState(*out)


def _add_rows(film_rows, row, slot, slot_ids):
  """film_rows[lane, slot[lane]] += row[lane], as a one-hot product."""
  hot = (slot[:, None] == slot_ids).to(torch.float32)
  return film_rows + row[:, None, :] * hot[:, :, None]


def _nee_row(rgb, valid, meta):
  """Film row of a resolved shadow ray and its slot: the contribution goes to
  the camera sum (and, for even sample iterations, the variance sum)."""
  width = rgb.shape[0]
  vmask = valid[..., None].to(torch.float32)
  even = meta[:, 1:2]
  z3 = torch.zeros((width, 3), device=rgb.device)
  row = torch.cat([rgb * vmask, z3, z3, rgb * vmask * even,
                   torch.zeros((width, 2), device=rgb.device)], dim=-1)
  return row, meta[:, 0].to(torch.int64)


def render_samples_static(scene, config, first_iteration: int, num_iterations: int,
                          pool_size: int = POOL_SIZE, device=None, row_offset: int = 0,
                          full_height: int | None = None):
  """Render num_iterations spp with a fixed pool; returns (FilmSums, rays).

  row_offset/full_height: the film is a band of rows of a larger film (see
  `make_lane_payload`); the returned table stays the band's own.

  Lane q owns pixels slot*p_base + q % p_base; films smaller than the pool
  widen it with k lanes per pixel, each owning n//k of the iterations. The
  pool runs as a cascade of phases of width p, p/4, p/16, ... (at least
  4096 lanes, at most four phases): when the alive count drops to the next
  width the survivors are compacted. `rays` is the number of path and shadow
  rays traced (not the transmittance segments or the subsurface walks'
  traces, as in the JAX package), as a 0-d int64 tensor.
  """
  device = resolve_device(device)
  scene = st.to_device(scene, device)
  w, h = config.film_width, config.film_height
  npix = w * h
  n = num_iterations
  s_slots = max(1, (npix + pool_size - 1) // pool_size)
  while npix % s_slots:
    s_slots += 1
  p_base = npix // s_slots
  k = 1
  if s_slots == 1:
    k = max(1, min(n, pool_size // npix))
    while n % k:
      k -= 1
  p = p_base * k
  n_lane = n // k
  per_lane = s_slots * n_lane
  slot_ids = torch.arange(s_slots, device=device)[None, :]
  end = 2 ** 30
  deferred = uses_deferred_nee(config)
  lens = camera_mod.lens_of(scene.camera)

  def phase(state, counter, lanes, pend_meta, film_rows, threshold: int):
    """Run the pool at width lanes.shape[0] until alive <= threshold (or,
    with threshold 0, until every lane is dead). Pending shadow rays are
    left for the caller to drain."""
    def ids_for(counter):
      slot = counter // n_lane
      it = first_iteration + (lanes // p_base) * n_lane + (counter % n_lane)
      return it * npix + slot * p_base + (lanes % p_base)

    def body_once(state, counter, film_rows, pend_meta):
      new_state = pt_step(scene, config, state)
      died = state.alive & ~new_state.alive

      dmask = died[..., None].to(torch.float32)
      even = (died & ((new_state.sample_iter % 2) == 0))[..., None].to(torch.float32)
      color = _lane_color(scene, config, new_state)
      alb = spx.to_film_rgb(new_state.view_albedo, new_state.wl, config.spectral)
      row = torch.cat([color * dmask, new_state.view_normal * dmask, alb * dmask,
                       color * even, dmask, even], dim=-1)
      slot = torch.clamp(counter // n_lane, 0, s_slots - 1)
      film_rows = _add_rows(film_rows, row, slot, slot_ids)
      if deferred:
        # resolved NEE from LAST step, credited to its origin slot and parity
        film_rows = _add_rows(film_rows, *_nee_row(new_state.res_rgb, new_state.res_valid,
                                                   pend_meta), slot_ids)
        pend_meta = torch.stack(
            [slot.to(torch.float32),
             ((new_state.sample_iter % 2) == 0).to(torch.float32)], dim=-1)

      counter = counter + died.to(counter.dtype)
      fresh = make_lane_payload(scene, config,
                                ids_for(torch.clamp(counter, max=per_lane - 1)), end, lens,
                                row_offset, full_height)
      regen = died & (counter < per_lane)
      merged = _pick(regen, fresh, new_state)
      # the pending shadow ray survives regeneration: it belongs to the
      # previous sample, credited via pend_meta and resolved next step
      merged = merged._replace(alive=torch.where(died, regen, new_state.alive),
                               psh_o=new_state.psh_o, psh_d=new_state.psh_d,
                               psh_tmax=new_state.psh_tmax, psh_rgb=new_state.psh_rgb)
      return merged, counter, film_rows, pend_meta

    def more(state):
      if threshold > 0:
        return state.alive.sum().item() > threshold
      return bool(state.alive.any().item())

    while more(state):
      for _ in range(_UNROLL):
        state, counter, film_rows, pend_meta = body_once(state, counter, film_rows, pend_meta)
    return state, counter, film_rows, pend_meta

  def drain(state, pend_meta, film_rows):
    """Resolve every lane's pending shadow ray (none without deferred NEE)."""
    if not deferred:
      return state, film_rows
    width = state.alive.shape[0]
    occ = trace_ops.trace_occluded(
        scene, state.psh_o, state.psh_d, torch.full((width,), em.kRayEpsilon, device=device),
        torch.clamp(state.psh_tmax, min=0.0))
    valid = (state.psh_tmax > 0.0) & ~occ
    rgb = torch.where(valid[..., None], state.psh_rgb, 0.0)
    film_rows = _add_rows(film_rows, *_nee_row(rgb, valid, pend_meta), slot_ids)
    return state._replace(psh_tmax=torch.full((width,), -1.0, device=device)), film_rows

  widths = [p]
  while widths[-1] // 4 >= 4096 and len(widths) < 4:
    widths.append(widths[-1] // 4)

  lane0 = torch.arange(p, dtype=torch.int64, device=device)
  init_it = first_iteration + (lane0 // p_base) * n_lane
  state = make_lane_payload(scene, config, init_it * npix + (lane0 % p_base), end, lens,
                            row_offset, full_height)
  counter = torch.zeros(p, dtype=torch.int64, device=device)
  lanes = lane0
  pend_meta = torch.zeros((p, 2), device=device)
  film_rows = torch.zeros((p, s_slots, _SUMS_WIDTH), device=device)
  table = torch.zeros((npix, _SUMS_WIDTH), device=device)

  for li, width in enumerate(widths):
    last = li == len(widths) - 1
    threshold = 0 if last else widths[li + 1]
    state, counter, film_rows, pend_meta = phase(
        state, counter, lanes, pend_meta, film_rows, threshold)
    state, film_rows = drain(state, pend_meta, film_rows)

    # fold this phase's film rows into the table
    if width == p:
      # lane = q*p_base + x: the k iteration-split copies of a pixel sum out
      folded = film_rows.permute(1, 0, 2).reshape(s_slots, k, p_base, _SUMS_WIDTH).sum(dim=1)
      table = table + folded.reshape(npix, _SUMS_WIDTH)
    else:
      pix = (torch.arange(s_slots, device=device)[None, :] * p_base
             + (lanes % p_base)[:, None]).reshape(-1)
      table = table.index_add(0, pix, film_rows.reshape(width * s_slots, _SUMS_WIDTH))

    if last:
      break

    # compact the surviving lanes (alive first, in lane order) to the next width
    nw = widths[li + 1]
    sel = torch.argsort((~state.alive).to(torch.int32), stable=True)[:nw]
    state = PTState(*(x if x.dim() == 0 else x[sel] for x in state))
    counter = counter[sel]
    lanes = lanes[sel]
    pend_meta = torch.zeros((nw, 2), device=device)
    film_rows = torch.zeros((nw, s_slots, _SUMS_WIDTH), device=device)

  return FilmSums(table), state.rays_traced


def render_preview(scene, config, pixel_size: int = 8, iterations: int = 1,
                   pool_size: int = POOL_SIZE, device=None) -> torch.Tensor:
  """Progressive preview: the film rendered at 1/pixel_size of its width
  and height, each pixel repeated pixel_size times along both axes (the
  camera-move preview of the interactive viewer). Returns the (H,W,3)
  camera image."""
  w, h = config.film_width, config.film_height
  pw = max(1, w // pixel_size)
  ph = max(1, h // pixel_size)
  small = dataclasses.replace(config, film_width=pw, film_height=ph)
  sums, _ = render_samples_static(scene, small, 0, iterations,
                                  pool_size=min(pool_size, pw * ph), device=device)
  img = finalize_film(sums, iterations, pw).camera.reshape(ph, pw, 3)
  img = img.repeat_interleave(pixel_size, dim=0).repeat_interleave(pixel_size, dim=1)
  return img[:h, :w]


def finalize_film(sums: FilmSums, iterations: int, width: int) -> film_mod.FilmState:
  """Convert accumulated sums to the FilmState mean-based layers."""
  w = width
  h = sums.table.shape[0] // w
  count = torch.clamp(sums.count, min=1.0)[..., None]
  vcount = torch.clamp(sums.var_count, min=1.0)[..., None]
  z = torch.zeros((h, w, 3), device=sums.table.device)
  return film_mod.FilmState(
      camera=(sums.cam_sum / count).reshape(h, w, 3),
      variance_half=(sums.var_sum / vcount).reshape(h, w, 3),
      normals=(sums.nrm_sum / count).reshape(h, w, 3),
      albedo=(sums.alb_sum / count).reshape(h, w, 3),
      light=z, light_iteration=z,
      iteration=torch.tensor(iterations, dtype=torch.int32, device=sums.table.device))


def render_stats(scene, config, iterations: int | None = None, pool_size: int = POOL_SIZE,
                 device=None):
  """`render`, also returning the rays traced: (FilmState, rays)."""
  n = config.samples if iterations is None else iterations
  sums, rays = render_samples_static(
      scene, config, 0, n,
      pool_size=min(pool_size, config.film_width * config.film_height * n), device=device)
  return finalize_film(sums, n, config.film_width), rays


def render(scene, config, iterations: int | None = None, pool_size: int = POOL_SIZE,
           device=None) -> film_mod.FilmState:
  """Render `iterations` spp (default: config.samples) on `device` (default:
  the CUDA card, which must exist)."""
  return render_stats(scene, config, iterations, pool_size, device)[0]


# ---------------------------------------------------------------------------
# One lane per pixel: the per-iteration driver.
# ---------------------------------------------------------------------------


def make_payload(scene, config, iteration: int, device=None) -> PTState:
  """The payload of one full-film iteration, one lane per pixel."""
  device = resolve_device(device)
  r = config.film_width * config.film_height
  ids = torch.arange(r, dtype=torch.int64, device=device) + iteration * r
  return make_lane_payload(scene, config, ids, (iteration + 1) * r)


def _finalize(scene, config, film_state: film_mod.FilmState, state: PTState):
  """Fold one full-film iteration's lanes into the film's running means."""
  w, h = config.film_width, config.film_height
  color = _lane_color(scene, config, state)
  albedo = spx.to_film_rgb(state.view_albedo, state.wl, config.spectral)
  return film_mod.accumulate_camera(film_state, color.reshape(h, w, 3),
                                    state.view_normal.reshape(h, w, 3), albedo.reshape(h, w, 3))


def render_iteration_stats(scene, config, film_state: film_mod.FilmState, iteration: int,
                           device=None):
  """One full-film iteration, each lane running until its path ends (every
  step traces its own shadow rays); returns (film, rays traced)."""
  device = resolve_device(device)
  scene = st.to_device(scene, device)
  state = make_payload(scene, config, iteration, device)
  while bool(state.alive.any().item()):
    for _ in range(_UNROLL):
      state = pt_step(scene, config, state, deferred=False)
  return _finalize(scene, config, film_state, state), state.rays_traced


def render_iteration(scene, config, film_state: film_mod.FilmState, iteration: int,
                     device=None) -> film_mod.FilmState:
  """One full-film sample-per-pixel iteration; returns the updated film."""
  return render_iteration_stats(scene, config, film_state, iteration, device)[0]


# ---------------------------------------------------------------------------
# The scatter pool: a lane that finishes adds its row to the film table and
# takes the next sample id, so the pool stays full for any path length. The
# adaptive render draws its pixels from a map through the same pool.
# ---------------------------------------------------------------------------


def _empty_sums(w: int, h: int, device) -> FilmSums:
  return FilmSums(torch.zeros((h * w, _SUMS_WIDTH), device=device))


def _scatter_pool(scene, config, payload_for, base: int, total: int, sums: FilmSums,
                  pool_size: int):
  """Run the regenerating pool over sample ids base .. base+total-1, lanes
  built by payload_for(ids, end); each step's finished lanes add their rows
  to `sums` (index_add: on the card the adds of one pixel land in atomic
  order). Returns (FilmSums, rays)."""
  device = sums.table.device
  p = min(pool_size, total)
  end = base + total
  state = payload_for(base + torch.arange(p, dtype=torch.int64, device=device), end)
  counter = torch.tensor(base + p, dtype=torch.int64, device=device)
  table = sums.table

  def body_once(state, counter, table):
    new_state = pt_step(scene, config, state, deferred=False)
    died = state.alive & ~new_state.alive
    color = _lane_color(scene, config, new_state)
    px = torch.where(died, new_state.pixel, 0)
    dmask = died[..., None].to(torch.float32)
    even = (died & ((new_state.sample_iter % 2) == 0))[..., None].to(torch.float32)
    alb = spx.to_film_rgb(new_state.view_albedo, new_state.wl, config.spectral)
    row = torch.cat([color * dmask, new_state.view_normal * dmask, alb * dmask,
                     color * even, dmask, even], dim=-1)
    table = table.index_add(0, px, row)
    # regenerate finished lanes with the next sample ids (prefix-sum ranks)
    new_ids = counter + torch.cumsum(died.to(torch.int64), 0) - 1
    fresh = payload_for(torch.where(died, new_ids, 0), end)
    regen = died & (new_ids < end)
    merged = _pick(regen, fresh, new_state)
    merged = merged._replace(alive=torch.where(died, regen, new_state.alive),
                             rays_traced=new_state.rays_traced)
    return merged, counter + died.sum(), table

  while bool(state.alive.any().item()):
    for _ in range(_UNROLL):
      state, counter, table = body_once(state, counter, table)
  return FilmSums(table), state.rays_traced


def render_samples(scene, config, first_iteration: int, num_iterations: int,
                   pool_size: int = POOL_SIZE, device=None):
  """Render num_iterations spp with the regenerating scatter pool; returns
  (FilmSums, rays). Lane seeds depend only on (pixel, iteration), never on
  the pool's schedule."""
  device = resolve_device(device)
  scene = st.to_device(scene, device)
  npix = config.film_width * config.film_height
  lens = camera_mod.lens_of(scene.camera)

  def payload_for(ids, end):
    return make_lane_payload(scene, config, ids, end, lens)

  return _scatter_pool(scene, config, payload_for, first_iteration * npix,
                       npix * num_iterations,
                       _empty_sums(config.film_width, config.film_height, device), pool_size)


# ---------------------------------------------------------------------------
# Adaptive sampling: after a minimum budget, only pixels whose full/half
# buffer deviation exceeds the noise threshold (dilated by a 5 px block)
# keep receiving samples; the pool draws pixel ids from an active-pixel map
# instead of raster order.
# ---------------------------------------------------------------------------

_ADAPTIVE_MIN_SAMPLES = 32
_ADAPTIVE_DILATION = 5
# sample ids of a mapped pass seed the RNG with the pixel plus this offset
_MAP_SEED = 0x85EBCA6B


def render_samples_mapped(scene, config, pixel_map: torch.Tensor, first_iteration: int,
                          num_iterations: int, sums: FilmSums, pool_size: int = POOL_SIZE,
                          device=None):
  """render_samples over a pixel map (the adaptive phase), adding to `sums`.

  pixel_map: (W*H,) — sample k goes to pixel pixel_map[k % npix]; the RNG is
  seeded by the unique sample id and the pixel, so repeated pixels stay
  decorrelated. Returns (FilmSums, rays)."""
  device = resolve_device(device)
  scene = st.to_device(scene, device)
  w, h = config.film_width, config.film_height
  npix = w * h
  lens = camera_mod.lens_of(scene.camera)
  pixel_map = pixel_map.to(device=device, dtype=torch.int64)

  def payload_for(sample_ids, end):
    pix = pixel_map[sample_ids % npix]
    base = make_lane_payload(scene, config, sample_ids, end, lens)
    state = rng.seed(sample_ids, (pix + _MAP_SEED) & 0xFFFFFFFF)
    state, wl_rnd = rng.next_float(state)
    wl = spmod.sample_wavelength(wl_rnd) if config.spectral else torch.zeros_like(wl_rnd)
    state, jit_rnd = rng.next_2d(state)
    uv = camera_mod.film_uv(pix % w, pix // w, w, h, jit_rnd - 0.5)
    state, lens_rnd = rng.next_2d(state)
    rays = camera_mod.generate_ray(scene.camera, uv, lens_rnd, lens, scene.images,
                                   config.equirectangular)
    return base._replace(ray_o=rays.o, ray_d=rays.d, t_min=rays.t_min, t_max=rays.t_max,
                         rng_state=state, wl=wl, pixel=pix, sample_iter=sample_ids // npix)

  return _scatter_pool(scene, config, payload_for, first_iteration * npix,
                       npix * num_iterations, FilmSums(sums.table.to(device)), pool_size)


def active_pixel_map(sums: FilmSums, width: int, threshold: float):
  """Noise-driven pixel map: the unconverged pixel ids (5 px dilated) in
  raster order, tiled so the map has npix entries. Returns (map, count of
  active pixels as a 0-d tensor)."""
  table = sums.table
  dev = table.device
  npix = table.shape[0]
  h = npix // width
  count = torch.clamp(sums.count, min=1.0)
  vcount = torch.clamp(sums.var_count, min=1.0)
  full_rgb = sums.cam_sum / count[..., None]
  half_rgb = sums.var_sum / vcount[..., None]
  # the luminance sums in the JAX reduction's order
  lum_w = (0.212671, 0.715160, 0.072169)
  full = full_rgb[:, 0] * lum_w[0] + full_rgb[:, 1] * lum_w[1] + full_rgb[:, 2] * lum_w[2]
  half = half_rgb[:, 0] * lum_w[0] + half_rgb[:, 1] * lum_w[1] + half_rgb[:, 2] * lum_w[2]
  noise = torch.abs(full - half) / torch.clamp(torch.abs(full), min=1e-4)
  active = (noise > threshold).reshape(h, width)
  k = _ADAPTIVE_DILATION
  pad = k // 2
  act = torch.nn.functional.pad(active, (pad, pad, pad, pad))
  dil = torch.zeros_like(active)
  for dy in range(k):
    for dx in range(k):
      dil = dil | act[dy:dy + h, dx:dx + width]
  flat = dil.reshape(-1)
  n_active = flat.to(torch.int64).sum()
  # active pixels first, each group in raster order (a stable sort on an
  # integer key)
  ids = torch.argsort((~flat).to(torch.int32), stable=True)
  idx = torch.arange(npix, device=dev) % torch.clamp(n_active, min=1)
  return ids[idx], n_active


def render_adaptive(scene, config, max_iterations: int | None = None, batch: int = 8,
                    device=None) -> film_mod.FilmState:
  """Progressive render with adaptive per-pixel termination: the first 32 spp
  (or all, if fewer) by the scatter pool, then batches of `batch` spp over
  the active-pixel map until max_iterations (default: config.samples) or
  no pixel is active."""
  device = resolve_device(device)
  scene = st.to_device(scene, device)
  n = config.samples if max_iterations is None else max_iterations
  w = config.film_width
  warm = min(_ADAPTIVE_MIN_SAMPLES, n)
  sums, _ = render_samples(scene, config, 0, warm, device=device)
  done = warm
  while done < n:
    k = min(batch, n - done)
    pmap, n_active = active_pixel_map(sums, w, config.noise_threshold)
    if int(n_active.item()) == 0:
      break
    sums, _ = render_samples_mapped(scene, config, pmap, done, k, sums, device=device)
    done += k
  return finalize_film(sums, done, w)
