"""Vertex connection and merging, with BDPT, BDPTFast and light tracing as
its sub-modes.

Counterpart of `etx_tracer_tpu/models/vcm.py`. One iteration runs:

- the LIGHT PASS: one lane per light path (as many paths as film pixels).
  The first `max_stored_vertices` bounces store each lane's connectable
  vertex in its own slot array; every bounce connects its vertex to the
  camera and scatter-adds the splat into the light image (through the
  any-hit kernel, or the transmittance walk with media). Past the stored
  depths the wavefront compacts to narrower widths as its lanes die.
- the GRID BUILD (merging only): the stored vertices sorted by a hash of
  their grid cell and a per-photon hash; a cell holding more than
  `max_photons_per_cell` photons keeps the first of them in that order,
  their throughput scaled by occupancy / cap.
- the CAMERA PASS: one lane per pixel, with direct emitter hits, next-event
  estimation, LANE-ALIGNED vertex connections (camera path i to light path
  i's stored vertices, all slots in one batched evaluation and one
  occlusion trace or transmittance walk) and merging (a scan of the eight
  neighbouring cells: an analytic Lambert pass, and a BSDF-dispatch pass
  for glossy lanes). It compacts by the same cascade, banking each lane's
  sums by its pixel.

`bdpt_options` turns merging off, `bdpt_fast_options` also swaps every
reverse pdf for the forward one, and `light_tracing_options` keeps only
the camera connections of the light pass. The integrator renders what the
port's path tracer renders: RGB and spectral (a light path and its camera
path share one wavelength), the Diffuse, Conductor, Dielectric, Thinfilm and
Boundary classes, media (free-path sampling on both walks, phase-function
connections, transmittance through Boundary interfaces) and subsurface
scattering (camera-side connections, NEE and merging at the exit), lit by
area and distant emitters (light paths start on the bounding sphere from
an environment or a directional emitter; camera paths that miss gather the
environment), through a pinhole, a thin lens or an equirectangular
camera. The JAX package's sharding parameters are here: `light_pass`
traces a slice of the light paths (`path_offset`, `n_valid`) into a splat
image of the whole film (`splat_shape`), and `camera_pass` renders a band
of rows (`pixel_offset`, `full_height`), for
`parallel/mesh.vcm_render_iteration_sharded`. A radiance clamp does not
apply to VCM in the JAX package either.

PyTorch runs eagerly: every JAX `while_loop` is a Python loop that reads
its condition on the host once an iteration, over the JAX loop's widths and
trip counts (every lane's RNG stream depends on them, through the media
loops); `render_chunk` and `render_chunk_stats` are plain loops over
`render_iteration`, and the radius schedule is always the eager one,
computed in float32 on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from etx_tracer_tpu_torch import resolve_device
from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.core import rng
from etx_tracer_tpu_torch.core import spectrum as spmod
from etx_tracer_tpu_torch.models import path_tracing as pt
from etx_tracer_tpu_torch.ops import trace as trace_ops
from etx_tracer_tpu_torch.render import camera as camera_mod
from etx_tracer_tpu_torch.render import emitters as emitters_mod
from etx_tracer_tpu_torch.render import film as film_mod
from etx_tracer_tpu_torch.render import media as media_mod
from etx_tracer_tpu_torch.render import spectral as spx
from etx_tracer_tpu_torch.render import subsurface as sss_mod
from etx_tracer_tpu_torch.render.bsdf import dispatch as bsdf_dispatch
from etx_tracer_tpu_torch.render.bsdf import lobes as lobes_mod
from etx_tracer_tpu_torch.render.bsdf.lobes import ShadingData
from etx_tracer_tpu_torch.scene import packed
from etx_tracer_tpu_torch.scene import types as st
from etx_tracer_tpu_torch.scene.types import MaterialClass as MC
from etx_tracer_tpu_torch.scene.types import SubsurfaceClass
from etx_tracer_tpu_torch.utils import validate

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class VCMOptions:
  """Strategy switches and the merge radius schedule."""
  direct_hit: bool = True
  connect_to_light: bool = True
  connect_to_camera: bool = True
  connect_vertices: bool = True
  enable_merging: bool = True
  enable_mis: bool = True
  initial_radius: float = 0.0   # 0: 5 * scene radius / the larger film side
  radius_decay: int = 256
  max_stored_vertices: int = 8
  # a cell holding more photons keeps a random subset of this many, their
  # throughput scaled by occupancy / cap (0: no cap)
  max_photons_per_cell: int = 16
  # BDPTFast: every reverse pdf replaced by the forward pdf of the same
  # evaluation (the weights still sum to one)
  fast_mis: bool = False


def bdpt_options() -> VCMOptions:
  """BDPT: VCM without merging."""
  return VCMOptions(enable_merging=False)


def bdpt_fast_options() -> VCMOptions:
  """BDPTFast: BDPT with approximate MIS weights (no reverse-pdf evaluations)."""
  return VCMOptions(enable_merging=False, fast_mis=True)


def light_tracing_options() -> VCMOptions:
  """Light tracing: camera connections of the light pass only, without MIS."""
  return VCMOptions(direct_hit=False, connect_to_light=False, connect_vertices=False,
                    enable_merging=False, enable_mis=False)


class VCMState(NamedTuple):
  """A light or camera wavefront, one row per lane."""
  ray_o: torch.Tensor
  ray_d: torch.Tensor
  throughput: torch.Tensor    # (R,C)
  gathered: torch.Tensor      # (R,C) camera-side sum
  d_vcm: torch.Tensor
  d_vc: torch.Tensor
  d_vm: torch.Tensor
  eta: torch.Tensor
  medium: torch.Tensor        # (R,) int32
  path_depth: torch.Tensor    # (R,) int32
  path_distance: torch.Tensor
  rng_state: torch.Tensor     # (R,) int64 holding a uint32
  wl: torch.Tensor
  alive: torch.Tensor
  delta_emitter: torch.Tensor  # light paths only
  local_emitter: torch.Tensor
  rays_traced: torch.Tensor   # () int64: closest-hit and occlusion rays launched


class LightVertices(NamedTuple):
  """Each light path's stored vertices, one slot a stored depth."""
  pos: torch.Tensor         # (R,V,3)
  nrm: torch.Tensor         # (R,V,3)
  geo_n: torch.Tensor       # (R,V,3)
  w_i: torch.Tensor         # (R,V,3)
  tan: torch.Tensor         # (R,V,3)
  btn: torch.Tensor         # (R,V,3)
  uv: torch.Tensor          # (R,V,2)
  throughput: torch.Tensor  # (R,V,C)
  d_vcm: torch.Tensor       # (R,V)
  d_vc: torch.Tensor        # (R,V)
  d_vm: torch.Tensor        # (R,V)
  mat: torch.Tensor         # (R,V) int32
  path_length: torch.Tensor  # (R,V) int32
  valid: torch.Tensor       # (R,V) bool
  is_medium: torch.Tensor   # (R,V) bool: a medium event, not a surface
  medium: torch.Tensor      # (R,V) int32


def _alloc_vertices(r: int, v: int, c: int, device) -> LightVertices:
  def z(*shape, dtype=torch.float32):
    return torch.zeros((r, v) + shape, dtype=dtype, device=device)
  return LightVertices(
      pos=z(3), nrm=z(3), geo_n=z(3), w_i=z(3), tan=z(3), btn=z(3), uv=z(2),
      throughput=z(c), d_vcm=z(), d_vc=z(), d_vm=z(),
      mat=z(dtype=torch.int32), path_length=z(dtype=torch.int32),
      valid=z(dtype=torch.bool), is_medium=z(dtype=torch.bool),
      medium=torch.full((r, v), -1, dtype=torch.int32, device=device))


def _mat(scene, idx) -> packed.MaterialRows:
  return packed.MaterialRows(scene.mat_table[idx])


def _at_wl(scene, wl):
  """The scene with every SPD evaluated at the lanes' wavelengths."""
  return scene._replace(spec_at_wl=(wl, spmod.bank_at_wl(scene.spec_values, wl)))


def _take(tup, sel):
  """Rows `sel` of every per-lane field of a NamedTuple (scalars kept)."""
  return type(tup)(*(x if x.dim() == 0 else x[sel] for x in tup))


def _alive_first(alive: torch.Tensor) -> torch.Tensor:
  """Lane order with the live lanes first, each group in lane order."""
  return torch.argsort((~alive).to(torch.int32), stable=True)


def _cascade_widths(n: int):
  widths = [n]
  while widths[-1] // 4 >= _CAMERA_CASCADE_MIN and len(widths) < 4:
    widths.append(widths[-1] // 4)
  return widths


def _mis(enable: bool, *w: torch.Tensor) -> torch.Tensor:
  """The balance-heuristic weight 1 / (1 + w[0] + w[1] + ...), summed left
  to right; 1 without MIS."""
  if not enable:
    return torch.ones_like(w[0])
  total = 1.0 + w[0]
  for x in w[1:]:
    total = total + x
  return 1.0 / total


def _reverse_pdf_of_sample(sc, sd: ShadingData, bs, upd, spectral: bool, classes):
  """The reverse pdf of each lane's sampled direction, where the next
  recurrences read it: surface lanes with a non-delta sample."""
  sd_rev, rev_classes = bsdf_dispatch.restrict(sd, upd & ~bs.is_delta, classes)
  return bsdf_dispatch.reverse_pdf(sc, sd_rev, bs.w_o, spectral, rev_classes)


def _cube(x):
  return x * x * x


class _Vertex(NamedTuple):
  """What a bounce's closest hit (or medium event) gives both passes."""
  hit: object
  upd: torch.Tensor           # a surface vertex (found, not Boundary, no medium event)
  is_boundary: torch.Tensor
  medium_event: torch.Tensor
  mv: object                  # the lanes' medium (None without media)
  msample: object             # the free-path sample (None without media)
  pos: torch.Tensor
  nrm: torch.Tensor
  tan: torch.Tensor
  btn: torch.Tensor
  uv: torch.Tensor
  trows: object
  mat: packed.MaterialRows
  rays_traced: torch.Tensor


def _meet(scene, sc, config, state: VCMState, eps) -> tuple:
  """A bounce's closest-hit trace, free-path sampling in the lanes' medium
  (drawing from every lane's stream) and the MIS recurrences at the new
  vertex. Returns (state, _Vertex, the RNG states after the sampling); the
  state keeps the RNG states it came with, from which the camera pass
  seeds its connections' streams. On a camera path (depth >= 1) the scale
  of d_vcm is always the squared segment; on a light path's first segment
  from a distant emitter it is 1."""
  r = state.alive.shape[0]
  dev = state.ray_o.device
  t_max = torch.where(state.alive, em.kMaxFloat, 0.0)
  hit = trace_ops.trace_closest(sc, state.ray_o, state.ray_d, eps, t_max)
  found = hit.found & state.alive
  rays_ct = state.rays_traced + state.alive.sum()

  medium_event = torch.zeros(r, dtype=torch.bool, device=dev)
  mv = msample = None
  rng_state = state.rng_state
  if config.has_media:
    mv = media_mod.gather_medium(sc, state.medium, state.wl, config.spectral)
    seg_t = torch.where(hit.found, hit.t, 2.0 * scene.bsphere_radius * 100.0)
    seg_t = torch.where(state.alive & mv.valid, seg_t, 0.0)
    msample, rng_state = media_mod.sample_medium(
        sc, mv, state.wl, state.throughput, rng_state, state.ray_o, state.ray_d,
        torch.clamp(seg_t, min=em.kRayEpsilon), config.spectral)
    in_medium = state.alive & mv.valid & (seg_t > 0.0)
    medium_event = in_medium & msample.sampled
    state = state._replace(throughput=torch.where(
        in_medium[..., None], state.throughput * msample.weight, state.throughput))
    found = found & ~medium_event

  pos, nrm, tan, btn, uv, _, _, trows = pt._interpolate_hit(sc, hit)
  mat = _mat(scene, trows.mat)
  if MC.Boundary in config.material_classes:
    is_boundary = found & (mat.cls == MC.Boundary)
  else:
    is_boundary = torch.zeros(r, dtype=torch.bool, device=dev)

  seg = state.path_distance + hit.t
  scale_vcm = torch.where((state.path_depth > 0) | state.local_emitter, em.sqr(seg), 1.0)
  cos_prev = torch.clamp(torch.abs(em.dot(nrm, -state.ray_d)), min=1e-6)
  upd = found & ~is_boundary
  d_vcm = torch.where(upd, state.d_vcm * scale_vcm / cos_prev, state.d_vcm)
  d_vc = torch.where(upd, state.d_vc / cos_prev, state.d_vc)
  d_vm = torch.where(upd, state.d_vm / cos_prev, state.d_vm)
  path_distance = torch.where(upd, 0.0, state.path_distance)
  if config.has_media:
    # a medium event folds the boundary distance and its own segment
    seg_m = state.path_distance + msample.t
    d_vcm = torch.where(medium_event, state.d_vcm * em.sqr(seg_m), d_vcm)
    path_distance = torch.where(medium_event, 0.0, path_distance)
  state = state._replace(d_vcm=d_vcm, d_vc=d_vc, d_vm=d_vm, path_distance=path_distance)
  return state, _Vertex(hit, upd, is_boundary, medium_event, mv, msample, pos, nrm, tan, btn,
                        uv, trows, mat, rays_ct), rng_state


def _advance(state: VCMState, v: _Vertex, bs, geo_n, pos, nrm, new_thr, new_depth, rev2,
             surf_alive, med_alive, rng_state, rays_ct, vc_weight: float, vm_weight: float,
             **fields) -> VCMState:
  """The state after a bounce: surface lanes take the sampled direction and
  the recurrences of its pdfs, Boundary lanes pass straight through into
  the medium on the far side, medium-event lanes keep what the phase
  continuation set."""
  cos_bsdf = torch.abs(em.dot(nrm, bs.w_o))
  inv = cos_bsdf / torch.clamp(bs.pdf, min=1e-20)
  nd_vc = torch.where(bs.is_delta, state.d_vc * cos_bsdf,
                      inv * (state.d_vc * rev2 + state.d_vcm + vm_weight))
  nd_vm = torch.where(bs.is_delta, state.d_vm * cos_bsdf,
                      inv * (state.d_vm * rev2 + state.d_vcm * vc_weight + 1.0))
  nd_vcm = torch.where(bs.is_delta, 0.0, 1.0 / torch.clamp(bs.pdf, min=1e-20))
  upd, is_boundary = v.upd, v.is_boundary
  new_o = pt._shading_pos(geo_n, pos, bs.w_o)
  ent = em.dot(nrm, state.ray_d) < 0.0
  b_medium = torch.where(ent, v.mat.int_medium, v.mat.ext_medium)
  b_o = pt._shading_pos(geo_n, pos, state.ray_d)
  return state._replace(
      ray_o=torch.where(v.medium_event[..., None], state.ray_o,
                        torch.where(is_boundary[..., None], b_o,
                                    torch.where(upd[..., None], new_o, state.ray_o))),
      ray_d=torch.where(upd[..., None], bs.w_o, state.ray_d),
      throughput=torch.where(upd[..., None], new_thr, state.throughput),
      d_vcm=torch.where(upd, nd_vcm, state.d_vcm),
      d_vc=torch.where(upd, nd_vc, state.d_vc),
      d_vm=torch.where(upd, nd_vm, state.d_vm),
      eta=torch.where(upd, state.eta * bs.eta, state.eta),
      medium=torch.where(is_boundary, b_medium, torch.where(upd, bs.medium, state.medium)),
      path_depth=torch.where(upd, new_depth, state.path_depth),
      path_distance=torch.where(is_boundary, state.path_distance + v.hit.t,
                                state.path_distance),
      rng_state=rng_state,
      alive=torch.where(v.medium_event, med_alive,
                        torch.where(is_boundary, state.alive, surf_alive)),
      rays_traced=rays_ct, **fields)


# ---------------------------------------------------------------------------
# Light pass
# ---------------------------------------------------------------------------


def _generate_light_state(scene, config, n_paths: int, iteration: int, vc_weight: float,
                          path_offset: int = 0, n_valid: int | None = None):
  """The light paths' first rays. Path i is seeded with tea(i, iteration)
  and draws its wavelength, the emitter, the point and the direction.

  path_offset: the lanes trace the light paths path_offset .. path_offset +
  n_paths - 1 (a slice of a sharded light pass, with the single-device
  pass's seeds); paths with an id >= n_valid start dead (the padding of
  uneven shards)."""
  r = n_paths
  dev = scene.tri_v0.device
  c = spx.channels(config.spectral)
  idx = torch.arange(r, dtype=torch.int64, device=dev) + path_offset
  state = rng.seed(idx, torch.full((r,), iteration, dtype=torch.int64, device=dev))
  state, wl_rnd = rng.next_float(state)
  wl = spmod.sample_wavelength(wl_rnd) if config.spectral else torch.zeros(r, device=dev)
  state, rnd_sel = rng.next_float(state)
  state, rnd_pos = rng.next_2d(state)
  state, rnd_dir = rng.next_2d(state)
  es = emitters_mod.sample_emission(scene, rnd_sel, rnd_pos, rnd_dir, wl, config.spectral)

  cos_t = em.dot(es.direction, es.normal)
  denom = torch.clamp(es.pdf_dir * es.pdf_area * es.pdf_sample, min=1e-20)
  throughput = es.value * (cos_t / denom)[..., None]
  valid = (es.pdf_dir > 0.0) & (cos_t > 0.0)
  if n_valid is not None:
    valid = valid & (idx < n_valid)
  side = torch.where(em.dot(es.geo_n, es.direction) >= 0, 1.0, -1.0)[..., None]
  origin = torch.where((es.triangle_index >= 0)[..., None],
                       em.offset_ray(es.origin, es.geo_n * side), es.origin)
  d_vcm = torch.where(es.is_distant, 1.0 / torch.clamp(es.pdf_area, min=1e-20),
                      1.0 / torch.clamp(es.pdf_dir, min=1e-20))
  d_vc = torch.where(es.is_delta, 0.0, torch.where(es.is_distant, 1.0, cos_t) / denom)
  return VCMState(
      ray_o=origin, ray_d=es.direction,
      throughput=torch.where(valid[..., None], throughput, 0.0),
      gathered=torch.zeros((r, c), device=dev),
      d_vcm=d_vcm, d_vc=d_vc, d_vm=d_vc * vc_weight,
      eta=torch.ones(r, device=dev), medium=es.medium_index,
      path_depth=torch.zeros(r, dtype=torch.int32, device=dev),
      path_distance=torch.zeros(r, device=dev),
      rng_state=state, wl=wl, alive=valid,
      delta_emitter=es.is_delta, local_emitter=~es.is_distant,
      rays_traced=torch.zeros((), dtype=torch.int64, device=dev))


def _light_step(scene, config, options: VCMOptions, state: VCMState, slot: int,
                verts: Optional[LightVertices], splat: torch.Tensor, n_paths: int,
                vc_weight: float, vm_weight: float, splat_rows: int, true_h: int) -> VCMState:
  """One light-path bounce over the wavefront: the vertex store at `slot`
  (into `verts`, in place, unless it is None), the camera connection
  (scatter-added into the flat (splat_rows*W,3) `splat`, in place, at the
  pixel its film position falls in on a film of `true_h` rows), the BSDF
  (or phase) continuation and Russian roulette."""
  spectral = config.spectral
  classes = config.material_classes
  r = state.alive.shape[0]
  dev = state.ray_o.device
  v_slots = options.max_stored_vertices
  film_w, film_h = config.film_width, config.film_height
  sc = _at_wl(scene, state.wl) if spectral else scene
  eps = torch.full((r,), em.kRayEpsilon, device=dev)
  state, v, rng_state = _meet(scene, sc, config, state, eps)
  state = state._replace(rng_state=rng_state)
  upd, medium_event = v.upd, v.medium_event
  mv, msample, pos, nrm, trows, mat, rays_ct = v.mv, v.msample, v.pos, v.nrm, v.trows, v.mat, \
      v.rays_traced
  tan, btn, uv = v.tan, v.btn, v.uv

  sd = ShadingData(w_i=state.ray_d, nrm=nrm, tan=tan, btn=btn, geo_n=trows.geo_n, tex=uv,
                   wl=state.wl, medium=state.medium, mat=mat)
  me3 = medium_event[..., None]

  # a connectable vertex: a non-delta surface or a medium event; it is
  # stored while slots remain, and connects to the camera at any depth
  storable = (upd & ~bsdf_dispatch.is_delta(sd)) | medium_event
  if options.connect_vertices or options.enable_merging:
    store = storable & (slot < v_slots)
  else:
    store = torch.zeros(r, dtype=torch.bool, device=dev)
  vslot = min(slot, v_slots - 1)
  v_pos = torch.where(me3, msample.pos, pos) if config.has_media else pos

  if verts is not None:
    def put(field, value):
      m = store
      while m.dim() < value.dim():
        m = m[..., None]
      field[:, vslot] = torch.where(m, value, field[:, vslot])

    zero3 = torch.zeros((r, 3), device=dev)
    media = config.has_media
    put(verts.pos, v_pos)
    put(verts.nrm, torch.where(me3, zero3, nrm) if media else nrm)
    put(verts.geo_n, torch.where(me3, zero3, trows.geo_n) if media else trows.geo_n)
    put(verts.w_i, state.ray_d)
    put(verts.tan, tan)
    put(verts.btn, btn)
    put(verts.uv, uv)
    put(verts.throughput, state.throughput)
    put(verts.d_vcm, state.d_vcm)
    put(verts.d_vc, state.d_vc)
    put(verts.d_vm, state.d_vm)
    put(verts.mat, torch.where(medium_event, 0, trows.mat) if media else trows.mat)
    put(verts.path_length, state.path_depth + 1)
    # a write at the clamped last slot keeps what is there
    verts.valid[:, vslot] |= store
    put(verts.is_medium, medium_event)
    put(verts.medium, state.medium)

  # --- connect to the camera ---
  rng_state = state.rng_state
  rng_state, lens_rnd = rng.next_2d(rng_state)
  cam = camera_mod.sample_film(scene.camera, v_pos, lens_rnd)
  w_o = cam.direction
  # only surface lanes that can connect read the lobe's value and pdfs
  sd_conn, conn_classes = bsdf_dispatch.restrict(sd, upd & ~bsdf_dispatch.is_delta(sd), classes)
  bsdf_val, bsdf_fwd_pdf = bsdf_dispatch.evaluate(sc, sd_conn, w_o, spectral, conn_classes,
                                                  config.diffuse_variations)
  rev_pdf = (bsdf_fwd_pdf if options.fast_mis
             else bsdf_dispatch.reverse_pdf(sc, sd_conn, w_o, spectral, conn_classes))
  if config.has_media:
    # a medium vertex scatters toward the camera by the phase function
    phase_cam = media_mod.phase_hg(state.ray_d, w_o, mv.phase_g)
    bsdf_val = torch.where(me3, phase_cam[..., None], bsdf_val)
    rev_pdf = torch.where(medium_event, phase_cam, rev_pdf)
  sh_o = pt._shading_pos(trows.geo_n, pos, w_o)
  if config.has_media:
    sh_o = torch.where(me3, msample.pos, sh_o)
    tr_con, rng_state = pt._trace_transmittance(sc, rng_state, state.medium, sh_o,
                                                cam.position, state.wl, spectral)
    occluded = torch.amax(tr_con, dim=-1) <= 0.0
  else:
    dist = em.length(cam.position - sh_o)
    occluded = trace_ops.trace_occluded(sc, sh_o, w_o, eps, dist * (1.0 - 1e-3))
  if options.connect_to_camera:
    rays_ct = rays_ct + (storable & cam.valid).sum()
  dp = cam.position - v_pos
  dist2 = torch.clamp(em.dot(dp, dp), min=1e-12)
  cam_cos = torch.clamp(-em.dot(cam.direction, scene.camera.direction), min=1e-9)
  pdf_dir_out = 1.0 / torch.clamp(scene.camera.area * _cube(cam_cos), min=1e-12)
  cos_cam = torch.abs(em.dot(nrm, w_o))
  vmw_cam = torch.full((r,), vm_weight, device=dev)
  fix = bsdf_dispatch.fix_shading_normal(trows.geo_n, nrm, state.ray_d, w_o)
  if config.has_media:
    cos_cam = torch.where(medium_event, 1.0, cos_cam)
    vmw_cam = torch.where(medium_event, 0.0, vmw_cam)
    fix = torch.where(medium_event, 1.0, fix)
  camera_pdf_area = pdf_dir_out * cos_cam / dist2
  w_light = camera_pdf_area * (vmw_cam + state.d_vcm + state.d_vc * rev_pdf)
  mis_w = _mis(options.enable_mis, w_light)
  contrib = bsdf_val * state.throughput * (cam.weight * mis_w * fix)[..., None]
  if config.has_media:
    contrib = contrib * tr_con
  can_connect = (storable & cam.valid & ~occluded
                 & (state.path_depth + 2 <= config.max_path_length))
  if not options.connect_to_camera:
    can_connect = torch.zeros_like(can_connect)
  if config.has_media:
    # connections from a medium point only where the medium allows them
    can_connect = can_connect & torch.where(medium_event, mv.explicit_connections, True)
  rgb = spx.to_film_rgb(contrib, state.wl, spectral)
  # splats average over the light paths, in per-pixel units
  rgb = rgb / float(n_paths) * (film_w * film_h)
  suv = cam.uv * 0.5 + 0.5
  fx = suv[..., 0] * film_w
  fy = suv[..., 1] * true_h
  if config.pixel_filter == "blackman-harris":
    # splats are jittered by the camera rays' reconstruction filter
    rng_state, f_rnd = rng.next_2d(rng_state)
    fj = camera_mod.blackman_harris_jitter(f_rnd)
    fx = fx + fj[..., 0]
    fy = fy + fj[..., 1]
  sx = torch.floor(fx).to(torch.int64)
  sy = torch.floor(fy).to(torch.int64)
  s_ok = can_connect & (sx >= 0) & (sx < film_w) & (sy >= 0) & (sy < splat_rows)
  sx = torch.clamp(sx, 0, film_w - 1)
  sy = torch.clamp(sy, 0, splat_rows - 1)
  splat.index_add_(0, sy * film_w + sx, torch.where(s_ok[..., None], rgb, 0.0))

  # --- BSDF sample and the recurrences of the next ray ---
  rng_state, rnd_bsdf = rng.next_n(rng_state, bsdf_dispatch.NUM_SAMPLE_RND)
  bs = bsdf_dispatch.sample(sc, sd, rnd_bsdf, spectral, classes, config.diffuse_variations)
  fixn = bsdf_dispatch.fix_shading_normal(trows.geo_n, nrm, state.ray_d, bs.w_o)
  new_thr = state.throughput * bs.weight * fixn[..., None]
  rng_state, rr_rnd = rng.next_float(rng_state)
  new_depth = state.path_depth + 1
  cont, new_thr = pt._random_continue(new_depth, config.rr_start, state.eta * bs.eta, rr_rnd,
                                      new_thr)
  rev2 = bs.pdf if options.fast_mis else _reverse_pdf_of_sample(sc, sd, bs, upd, spectral,
                                                                 classes)
  surf_alive = (upd & cont & (bs.pdf > 0.0) & (new_depth + 1 <= config.max_path_length)
                & (torch.amax(new_thr, dim=-1) > 0.0))
  if config.has_media:
    state, rng_state, med_alive = _phase_continue(config, state, mv, msample, medium_event,
                                                  rng_state)
  else:
    med_alive = state.alive
  return _advance(state, v, bs, trows.geo_n, pos, nrm, new_thr, new_depth, rev2, surf_alive,
                  med_alive, rng_state, rays_ct, vc_weight, vm_weight)


def _phase_continue(config, state: VCMState, mv, msample, medium_event, rng_state):
  """The medium-event lanes' continuation: a phase-sampled direction, its
  recurrences and Russian roulette. Returns (state, rng_state, alive)."""
  rng_state, m_rnd_phase = rng.next_2d(rng_state)
  phase_dir = media_mod.sample_phase_hg(state.ray_d, mv.phase_g, m_rnd_phase)
  phase_pdf = media_mod.phase_hg(state.ray_d, phase_dir, mv.phase_g)
  inv_p = 1.0 / torch.clamp(phase_pdf, min=1e-20)
  md_vc = inv_p * (state.d_vc * phase_pdf + state.d_vcm)
  md_vm = inv_p * (state.d_vm * phase_pdf)
  rng_state, m_rr = rng.next_float(rng_state)
  m_cont, m_thr = pt._random_continue(state.path_depth + 1, config.rr_start, state.eta, m_rr,
                                      state.throughput)
  med_alive = medium_event & m_cont & (state.path_depth + 2 <= config.max_path_length)
  me, me3 = medium_event, medium_event[..., None]
  state = state._replace(
      ray_o=torch.where(me3, msample.pos, state.ray_o),
      ray_d=torch.where(me3, phase_dir, state.ray_d),
      throughput=torch.where(me3, m_thr, state.throughput),
      d_vcm=torch.where(me, inv_p, state.d_vcm),
      d_vc=torch.where(me, md_vc, state.d_vc),
      d_vm=torch.where(me, md_vm, state.d_vm),
      path_depth=torch.where(me, state.path_depth + 1, state.path_depth))
  return state, rng_state, med_alive


def light_pass(scene, config, options: VCMOptions, iteration: int, n_paths: int,
               vc_weight: float, vm_weight: float, path_offset: int = 0,
               n_valid: int | None = None, splat_shape: tuple | None = None):
  """Trace `n_paths` light paths; returns (vertices, splat image (rows,W,3),
  final state with the full-width wavelengths).

  path_offset, n_valid: the slice of a sharded light pass
  (`_generate_light_state`). splat_shape: (image_rows, true_film_height),
  the rows of the splat image (the padded full film of a sharded pass) and
  the film height that maps a film position to a row; default
  (config.film_height,) * 2.

  The walk runs to `config.max_path_length` while any lane lives. The
  first `max_stored_vertices` bounces (when connections or merging need
  vertices) keep the lanes in place, since slot arrays are lane-indexed;
  later bounces store nothing and compact to widths n, n/4, n/16, ...
  (at least `_CAMERA_CASCADE_MIN` lanes, four at most) as lanes die."""
  c = spx.channels(config.spectral)
  dev = scene.tri_v0.device
  v_slots = options.max_stored_vertices
  state = _generate_light_state(scene, config, n_paths, iteration, vc_weight, path_offset,
                                n_valid)
  verts = _alloc_vertices(n_paths, v_slots, c, dev)
  film_w = config.film_width
  splat_rows, true_h = splat_shape or (config.film_height, config.film_height)
  splat = torch.zeros((splat_rows * film_w, 3), device=dev)
  max_depth = config.max_path_length
  wl0 = state.wl

  def step(state, slot, with_verts):
    state = _light_step(scene, config, options, state, slot, verts if with_verts else None,
                        splat, n_paths, vc_weight, vm_weight, splat_rows, true_h)
    if config.validate:
      validate.check_finite("vcm:light_pass",
                            throughput=torch.where(state.alive[..., None], state.throughput, 0.0),
                            d_vcm=torch.where(state.alive, state.d_vcm, 0.0), splat_img=splat)
    return state

  needs_verts = options.connect_vertices or options.enable_merging
  phase_a = min(v_slots, max_depth) if needs_verts else 0
  slot = 0
  while slot < phase_a and bool(state.alive.any().item()):
    state = step(state, slot, True)
    slot += 1

  widths = _cascade_widths(n_paths)
  for li in range(len(widths)):
    last = li == len(widths) - 1
    while slot < max_depth and (bool(state.alive.any().item()) if last
                                else state.alive.sum().item() > widths[li + 1]):
      state = step(state, slot, False)
      slot += 1
    if last:
      break
    state = _take(state, _alive_first(state.alive)[:widths[li + 1]])
  return verts, splat.reshape(splat_rows, film_w, 3), state._replace(wl=wl0)


# ---------------------------------------------------------------------------
# Merge grid: vertices sorted by cell hash, ranges by binary search
# ---------------------------------------------------------------------------


class MergeGrid(NamedTuple):
  sorted_cell: torch.Tensor     # (N,) int64 cell hash per sorted vertex
  pos: torch.Tensor             # (N,3)
  nrm: torch.Tensor             # (N,3)
  w_i: torch.Tensor             # (N,3)
  d_vcm: torch.Tensor           # (N,)
  d_vm: torch.Tensor            # (N,)
  path_length: torch.Tensor     # (N,) int32
  throughput_rgb: torch.Tensor  # (N,3) throughput / sampling pdf in RGB, cap-scaled
  valid: torch.Tensor           # (N,) bool
  grid_min: torch.Tensor        # (3,)
  cell_size: float              # a float32 value
  # one packed row a photon: pos, nrm, w_i, d_vcm, d_vm, thr_rgb (cap-scaled),
  # valid, a zero: the Lambert scan reads one row per candidate
  rows: torch.Tensor = None     # (N,16)
  cell_cap: int = 0


_HASH_MASK = (1 << 16) - 1


def _cell_hash(ix, iy, iz):
  """The 73856093 / 19349663 / 83492791 hash of a cell's int coordinates.
  int32 products wrap; only their low 16 bits survive the mask, and those
  are the low 16 bits of the int64 products."""
  ix, iy, iz = (t.to(torch.int64) for t in (ix, iy, iz))
  return ((ix * 73856093) ^ (iy * 19349663) ^ (iz * 83492791)) & _HASH_MASK


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
  """a * k mod 2^32 for a in [0, 2^32), in int64 without overflow: the
  product is split at bit 16 of a."""
  lo = (a & 0xFFFF) * k
  hi = (((a >> 16) * k) & 0xFFFF) << 16
  return (lo + hi) & _MASK32


def _bits32(x: torch.Tensor) -> torch.Tensor:
  """A float32 tensor's bits as int64 values in [0, 2^32)."""
  return x.contiguous().view(torch.int32).to(torch.int64) & _MASK32


def build_merge_grid(scene, verts: LightVertices, wl_lanes, radius: float, spectral: bool,
                     cell_cap: int = 16) -> MergeGrid:
  """Flatten the stored vertices and sort them by (cell hash, per-photon
  hash) (a stable sort of one composite key, the JAX package's uint32
  key computed in int64). `cell_cap` > 0: a cell's first `cell_cap`
  photons in that order are kept, the rest dropped, and the kept ones'
  throughput scaled by occupancy / cap."""
  r, v = verts.valid.shape
  n = r * v
  dev = verts.pos.device

  def flat(x):
    return x.reshape((n,) + tuple(x.shape[2:]))

  pos = flat(verts.pos)
  # medium vertices do not merge
  valid = flat(verts.valid) & ~flat(verts.is_medium)
  cell_size = float(np.float32(2.0) * np.float32(radius))
  grid_min = scene.bsphere_center - scene.bsphere_radius - cell_size
  # a tensor divisor: the card's division by a host scalar multiplies by its
  # reciprocal, and the cell of a vertex must not depend on the device
  m = torch.floor((pos - grid_min) / torch.full((), cell_size, device=dev)).to(torch.int32)
  cell = _cell_hash(m[:, 0], m[:, 1], m[:, 2])
  cell = torch.where(valid, cell, _HASH_MASK + 1)  # invalid vertices sort last

  h = _mul32(torch.arange(n, dtype=torch.int64, device=dev), 0x9E3779B9)
  h = h ^ _bits32(pos[:, 0])
  h = _mul32(h, 0x85EBCA6B)
  h = h ^ _bits32(pos[:, 2])
  key = cell * 32768 + (h >> 17)
  order = torch.sort(key, stable=True).indices

  thr = flat(verts.throughput)
  if spectral:
    # RGB of throughput / sampling pdf, scaled by the luminance basis
    wl_v = torch.repeat_interleave(wl_lanes, v)
    thr_rgb = spx.to_film_rgb(thr, wl_v, True) * em.constant(
        (0.817660332, 1.05418909, 1.09945524), dev)
  else:
    thr_rgb = thr
  nrm_f, w_i_f = flat(verts.nrm), flat(verts.w_i)
  d_vcm_f, d_vm_f = flat(verts.d_vcm), flat(verts.d_vm)
  packed_rows = torch.cat([pos, nrm_f, w_i_f, d_vcm_f[:, None], d_vm_f[:, None], thr_rgb,
                           valid.to(torch.float32)[:, None], torch.zeros((n, 1), device=dev)],
                          dim=1)

  cell_s = cell[order]
  rows_s = packed_rows[order]
  valid_s = valid[order]
  if cell_cap and cell_cap > 0:
    seg_start = torch.searchsorted(cell_s, cell_s, right=False)
    seg_end = torch.searchsorted(cell_s, cell_s, right=True)
    rank = torch.arange(n, device=dev) - seg_start
    occ = (seg_end - seg_start).to(torch.float32)
    scale = torch.clamp(occ / cell_cap, min=1.0)
    valid_s = valid_s & (rank < cell_cap)
    rows_s = torch.cat([rows_s[:, :11], rows_s[:, 11:14] * scale[:, None],
                        valid_s.to(torch.float32)[:, None], rows_s[:, 15:]], dim=1)
    thr_scale = scale
  else:
    thr_scale = torch.ones(n, device=dev)
  return MergeGrid(
      sorted_cell=cell_s, pos=pos[order], nrm=nrm_f[order], w_i=w_i_f[order],
      d_vcm=d_vcm_f[order], d_vm=d_vm_f[order], path_length=flat(verts.path_length)[order],
      throughput_rgb=thr_rgb[order] * thr_scale[:, None], valid=valid_s,
      grid_min=grid_min, cell_size=cell_size, rows=rows_s,
      cell_cap=int(cell_cap or 0))


def _segment_range(grid: MergeGrid, cell):
  return (torch.searchsorted(grid.sorted_cell, cell, right=False),
          torch.searchsorted(grid.sorted_cell, cell, right=True))


# candidates examined per neighbour cell by the glossy pass; the Lambert
# pass scans to the largest occupancy of the lanes' cells, at most
# `_MERGE_SCAN_CAP` (or the grid's cell cap)
_MERGE_SCAN = 32
_MERGE_SCAN_CAP = 128

# films below this many lanes run each pass's walk as a single phase
_CAMERA_CASCADE_MIN = 4096


def _sum3(a, b):
  """Per-row dot product over a trailing axis of 3, in component order."""
  return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def merge_gather(scene, grid: MergeGrid, sd: ShadingData, state: VCMState, radius: float,
                 vc_weight: float, options: VCMOptions, classes, spectral: bool,
                 variations=(0,), exit_mask=None, exit_weight=None, participates=None):
  """The photons within `radius` of each lane's position (`state.ray_o`)
  in the eight neighbouring cells, weighted and summed: (R,3) RGB.

  Two passes. Lambert lanes (Diffuse when `variations`, the diffuse
  variations present, is Lambert's alone, or a subsurface exit,
  `exit_mask`, which shades white diffuse times `exit_weight`) take an
  analytic pass:
  for each k below the largest occupancy of any lane's cells (at most the
  grid's cap), the k-th photon of all eight cells at once. Other non-delta
  lanes take the BSDF dispatch, one photon of one cell a step, for the
  first `_MERGE_SCAN` photons of each cell (steps past every lane's
  occupancy add nothing and are skipped). A pass runs only when one of its
  lanes participates."""
  r = sd.w_i.shape[0]
  dev = sd.w_i.device
  pos = state.ray_o
  m = (pos - grid.grid_min) / torch.full((), grid.cell_size, device=dev)
  mf = torch.floor(m)
  ac = mf.to(torch.int32)
  bc = ac + torch.where(m - mf < 0.5, -1, 1).to(torch.int32)
  w_cam_base = state.d_vcm * vc_weight
  r2 = float(np.float32(radius) * np.float32(radius))
  r2_safe = max(r2, float(np.float32(1e-20)))

  cells = torch.stack([
      _cell_hash(bc[:, 0] if ci & 1 else ac[:, 0], bc[:, 1] if ci & 2 else ac[:, 1],
                 bc[:, 2] if ci & 4 else ac[:, 2]) for ci in range(8)], dim=0)  # (8,R)
  starts, ends = _segment_range(grid, cells)
  n_last = grid.pos.shape[0] - 1

  lambert_ok = tuple(variations) == (0,)
  is_lambert = sd.mat.cls == MC.Diffuse
  if not lambert_ok:
    is_lambert = torch.zeros_like(is_lambert)
  if exit_mask is not None:
    is_lambert = is_lambert | exit_mask
  alb = lobes_mod._scattering(scene, sd, spectral)
  if exit_mask is not None:
    alb = torch.where(exit_mask[..., None], exit_weight, alb)
  # the shading normal turned toward the incident side
  n_eff = sd.nrm * torch.where(em.dot(sd.w_i, sd.nrm) < 0.0, 1.0, -1.0)[..., None]
  rev_lambert = em.kInvPi * torch.clamp(em.dot(-sd.w_i, n_eff), min=0.0)
  part = participates if participates is not None else torch.ones(r, dtype=torch.bool,
                                                                  device=dev)

  if spectral:
    # the film RGB of a unit response at each lane's wavelength: the
    # conversion is linear, so one evaluation serves every photon
    rgb_unit = spx.to_film_rgb(torch.ones((r, 1), device=dev), state.wl, True)

  def to_rgb(fval, lead_shape):
    return fval[..., 0:1] * rgb_unit.expand(lead_shape + (3,)) if spectral else fval

  merged = torch.zeros((r, 3), device=dev)
  occupancy = ends - starts
  scan_cap = grid.cell_cap if grid.cell_cap else _MERGE_SCAN_CAP
  if bool((part & is_lambert).any().item()):
    kmax = min(int(occupancy.max().item()), scan_cap)
    for k in range(kmax):
      j = torch.clamp(starts + k, max=n_last)
      in_range = (starts + k) < ends
      rows = grid.rows[j]                               # (8,R,16)
      d = rows[..., 0:3] - pos[None]
      dist2 = _sum3(d, d)
      ok = in_range & (rows[..., 14] > 0.5) & (dist2 <= r2) & is_lambert[None]
      ok = ok & (_sum3(sd.nrm[None], rows[..., 3:6]) > em.kEpsilon)
      # the diffuse lobe's hemisphere test in the incident-side frame
      cos_sgn = _sum3(n_eff[None], -rows[..., 6:9])
      lam_valid = cos_sgn > em.kEpsilon
      foc = alb[None] * em.kInvPi * lam_valid[..., None]
      bsdf_pdf = torch.where(lam_valid, cos_sgn * em.kInvPi, 0.0)
      rev_pdf = bsdf_pdf if options.fast_mis else rev_lambert[None].expand(8, r)
      w_light = rows[..., 9] * vc_weight + rows[..., 10] * bsdf_pdf
      w_camera = w_cam_base[None] + state.d_vm[None] * rev_pdf
      weight = _mis(options.enable_mis, w_light, w_camera)
      kern = torch.clamp(2.0 * (1.0 - dist2 / r2_safe), min=0.0)
      c_rgb = to_rgb(foc * state.throughput[None], (8, r))
      contrib = c_rgb * rows[..., 11:14] * (kern * weight)[..., None]
      ok = ok & (bsdf_pdf > 0.0)
      merged = merged + torch.where(ok[..., None], contrib, 0.0).sum(dim=0)

  glossy_classes = any(c not in (MC.Diffuse, MC.Mirror, MC.Void, MC.Boundary) for c in classes)
  if (glossy_classes or not lambert_ok) and bool((part & ~is_lambert).any().item()):
    steps = torch.clamp(occupancy.amax(dim=1), max=_MERGE_SCAN).tolist()
    sd_hard, classes = bsdf_dispatch.restrict(sd, ~is_lambert, classes)
    for ci in range(8):
      start, end = starts[ci], ends[ci]
      for k in range(int(steps[ci])):
        j = torch.clamp(start + k, max=n_last)
        in_range = (start + k) < end
        d = grid.pos[j] - pos
        dist2 = em.dot(d, d)
        ok = in_range & grid.valid[j] & (dist2 <= r2) & ~is_lambert
        ok = ok & (em.dot(sd.nrm, grid.nrm[j]) > em.kEpsilon)
        w_in = grid.w_i[j]
        bsdf_val, bsdf_pdf = bsdf_dispatch.evaluate(scene, sd_hard, -w_in, spectral, classes,
                                                    variations)
        rev_pdf = (bsdf_pdf if options.fast_mis
                   else bsdf_dispatch.reverse_pdf(scene, sd_hard, -w_in, spectral, classes))
        cos_o = torch.abs(em.dot(sd.nrm, -w_in))
        foc = bsdf_val / torch.clamp(cos_o, min=1e-6)[..., None]
        w_light = grid.d_vcm[j] * vc_weight + grid.d_vm[j] * bsdf_pdf
        w_camera = w_cam_base + state.d_vm * rev_pdf
        weight = _mis(options.enable_mis, w_light, w_camera)
        kern = torch.clamp(2.0 * (1.0 - dist2 / r2_safe), min=0.0)
        c_rgb = to_rgb(foc * state.throughput, (r,))
        contrib = c_rgb * grid.throughput_rgb[j] * (kern * weight)[..., None]
        ok = ok & (bsdf_pdf > 0.0)
        merged = merged + torch.where(ok[..., None], contrib, 0.0)
  return merged


# ---------------------------------------------------------------------------
# Camera pass
# ---------------------------------------------------------------------------


def _repeat(x, v: int):
  return torch.repeat_interleave(x, v, dim=0)


def _connect_vertices(sc, scene, config, options: VCMOptions, state: VCMState,
                      verts: LightVertices, sd: ShadingData, sd_eval: ShadingData, cam_classes,
                      pos, nrm, upd, medium_event, mv, msample, sss_ok, sss_gather,
                      vm_weight: float):
  """Every camera lane to each of its light path's stored vertices, as one
  (R*V)-wide evaluation and one occlusion trace (with media: one
  transmittance walk whose lane streams are seeded from (the lane's state,
  the slot)). Returns (the (R,C) contributions, the rays counted)."""
  spectral = config.spectral
  classes = config.material_classes
  r = state.alive.shape[0]
  dev = state.ray_o.device
  v = options.max_stored_vertices
  rv = r * v

  def fl(a):
    return a.reshape((rv,) + tuple(a.shape[2:]))

  def rp(a):
    return _repeat(a, v)

  lv_pos, lv_nrm, lv_geo, lv_wi = fl(verts.pos), fl(verts.nrm), fl(verts.geo_n), fl(verts.w_i)
  lv_valid = fl(verts.valid)
  target_len = rp(state.path_depth) + fl(verts.path_length) + 1
  # the camera vertex: the surface hit, or the medium point
  cpos = torch.where(medium_event[..., None], msample.pos, pos) if config.has_media else pos
  d = lv_pos - rp(cpos)
  dist2 = torch.clamp(_sum3(d, d), min=1e-12)
  w_o = d / torch.sqrt(dist2)[..., None]

  wl_rep = rp(state.wl)
  sc_big = sc
  if spectral and sc.spec_at_wl is not None:
    sc_big = sc._replace(spec_at_wl=(wl_rep, rp(sc.spec_at_wl[1])))
  sd_big = ShadingData(*(packed.MaterialRows(rp(x._rows)) if isinstance(x, packed.MaterialRows)
                         else rp(x) for x in sd_eval))._replace(wl=wl_rep)
  cb_val, cb_pdf = bsdf_dispatch.evaluate(sc_big, sd_big, w_o, spectral, cam_classes,
                                          config.diffuse_variations)
  c_rev = cb_pdf if options.fast_mis else bsdf_dispatch.reverse_pdf(sc_big, sd_big, w_o,
                                                                    spectral, cam_classes)
  if config.has_subsurface:
    sss_b = rp(sss_ok)
    white = em.kInvPi * torch.clamp(_sum3(sd_big.nrm, w_o), min=0.0)
    cb_val = torch.where(sss_b[..., None], white[..., None] * rp(sss_gather.weight), cb_val)
    cb_pdf = torch.where(sss_b, white, cb_pdf)
    c_rev = torch.where(sss_b, em.kInvPi * torch.abs(_sum3(sd_big.w_i, sd_big.nrm)), c_rev)
  if config.has_media:
    # a camera vertex in a medium: the phase function for the BSDF
    me_b = rp(medium_event)
    p_c = media_mod.phase_hg(rp(state.ray_d), w_o, rp(mv.phase_g))
    cb_val = torch.where(me_b[..., None], p_c[..., None], cb_val)
    cb_pdf = torch.where(me_b, p_c, cb_pdf)
    c_rev = torch.where(me_b, p_c, c_rev)

  lsd = ShadingData(w_i=lv_wi, nrm=lv_nrm, tan=fl(verts.tan), btn=fl(verts.btn), geo_n=lv_geo,
                    tex=fl(verts.uv), wl=wl_rep, medium=rp(state.medium),
                    mat=_mat(scene, fl(verts.mat)))
  # only stored vertices are read on the light side (`cam_classes`: the
  # camera side's lobes)
  lsd, light_classes = bsdf_dispatch.restrict(lsd, lv_valid, classes)
  lb_val, lb_pdf = bsdf_dispatch.evaluate(sc_big, lsd, -w_o, spectral, light_classes,
                                          config.diffuse_variations)
  l_rev = lb_pdf if options.fast_mis else bsdf_dispatch.reverse_pdf(sc_big, lsd, -w_o,
                                                                    spectral, light_classes)
  w_dot_l = -_sum3(lv_nrm, w_o)
  fix = bsdf_dispatch.fix_shading_normal(lv_geo, lv_nrm, lv_wi, -w_o)
  vmw_pair = torch.full((rv,), vm_weight, device=dev)
  cam_factor = torch.abs(_sum3(rp(nrm), w_o))
  if config.has_media:
    # a light vertex in a medium: the phase function on the light side; a
    # medium at either end takes merging out of the pair's weight
    lv_is_med = fl(verts.is_medium)
    lv_g = scene.mediums.phase_g[torch.clamp(fl(verts.medium), min=0)]
    p_l = media_mod.phase_hg(lv_wi, -w_o, lv_g)
    lb_val = torch.where(lv_is_med[..., None], p_l[..., None], lb_val)
    lb_pdf = torch.where(lv_is_med, p_l, lb_pdf)
    l_rev = torch.where(lv_is_med, p_l, l_rev)
    w_dot_l = torch.where(lv_is_med, 1.0, w_dot_l)
    fix = torch.where(lv_is_med, 1.0, fix)
    vmw_pair = torch.where(lv_is_med, 0.0, vmw_pair)
    cam_factor = torch.where(me_b, 1.0, cam_factor)
    vmw_pair = torch.where(me_b, 0.0, vmw_pair)
  cam_area_pdf = cb_pdf * torch.abs(w_dot_l) / dist2
  light_area_pdf = lb_pdf * cam_factor / dist2
  w_light = cam_area_pdf * (vmw_pair + fl(verts.d_vcm) + fl(verts.d_vc) * l_rev)
  w_camera = light_area_pdf * (vmw_pair + rp(state.d_vcm) + rp(state.d_vc) * c_rev)
  weight = _mis(options.enable_mis, w_light, w_camera)
  sh_o = pt._shading_pos(rp(sd.geo_n), rp(pos), w_o)
  conn_lane = rp(upd)
  if config.has_media:
    sh_o = torch.where(me_b[..., None], rp(msample.pos), sh_o)
    conn_lane = conn_lane | (me_b & rp(mv.explicit_connections))
  if config.has_media:
    slot_ids = torch.arange(v, dtype=torch.int64, device=dev).repeat(r)
    rng_rv = rng.seed(rp(state.rng_state), slot_ids)
    tr_vc, _ = pt._trace_transmittance(sc, rng_rv, rp(state.medium), sh_o, lv_pos, wl_rep,
                                       spectral)
    occ = torch.amax(tr_vc, dim=-1) <= 0.0
  else:
    seg_len = em.length(lv_pos - sh_o)
    occ = trace_ops.trace_occluded(sc, sh_o, w_o, torch.full((rv,), em.kRayEpsilon, device=dev),
                                   seg_len * (1.0 - 1e-3))
  ok = (conn_lane & lv_valid & ~occ & (cb_pdf > 0.0) & (lb_pdf > 0.0)
        & (target_len + 1 <= config.max_path_length))
  contrib = (cb_val * rp(state.throughput)) * (lb_val * fl(verts.throughput)) \
      * (weight * fix / dist2)[..., None]
  if config.has_media:
    contrib = contrib * tr_vc
  contrib = torch.where(ok[..., None], contrib, 0.0)
  return contrib.reshape(r, v, -1).sum(dim=1), (conn_lane & lv_valid).sum()


def _camera_step(scene, config, options: VCMOptions, state: VCMState, verts: LightVertices,
                 grid: Optional[MergeGrid], radius: float, vc_weight: float, vm_weight: float):
  """One camera-path bounce: direct hit, NEE, vertex connections and
  merging at the new vertex, then the continuation. Returns (state, the
  (R,3) merged RGB of this bounce)."""
  spectral = config.spectral
  classes = config.material_classes
  r = state.alive.shape[0]
  dev = state.ray_o.device
  sc = _at_wl(scene, state.wl) if spectral else scene
  eps = torch.full((r,), em.kRayEpsilon, device=dev)
  state, v, rng_state = _meet(scene, sc, config, state, eps)
  upd, medium_event = v.upd, v.medium_event
  mv, msample, pos, nrm, trows, mat, rays_ct = v.mv, v.msample, v.pos, v.nrm, v.trows, v.mat, \
      v.rays_traced
  tan, btn, uvt = v.tan, v.btn, v.uv
  me3 = medium_event[..., None]
  gathered = state.gathered

  sd = ShadingData(w_i=state.ray_d, nrm=nrm, tan=tan, btn=btn, geo_n=trows.geo_n, tex=uvt,
                   wl=state.wl, medium=state.medium, mat=mat)

  # --- a miss gathers the environment (a missed lane's d_vcm is the one it
  # came with: `_meet` updates hit lanes only) ---
  if config.num_env_emitters > 0:
    env = emitters_mod.env_contribution(
        sc, state.ray_d, state.wl, state.path_depth <= 1,
        torch.ones(r, dtype=torch.bool, device=dev), 1.0 / torch.clamp(state.d_vcm, min=1e-20),
        config.num_env_emitters, spectral)
    miss = state.alive & ~v.hit.found
    gathered = gathered + torch.where(miss[..., None], state.throughput * env, 0.0)

  # --- a direct emitter hit ---
  if options.direct_hit:
    emitter_idx = torch.where(upd, trows.emitter, -1)
    e_value, e_pdf_area, e_pdf_dir, e_pdf_dir_out = emitters_mod.area_radiance(
        sc, emitter_idx, state.ray_o, pos, state.path_depth == 1, state.wl, spectral)
    e_disc = emitters_mod.discrete_pdf(sc, torch.clamp(emitter_idx, min=0))
    w_camera = state.d_vcm * e_pdf_area * e_disc + state.d_vc * e_pdf_dir_out * e_disc
    weight = torch.where(state.path_depth > 1, _mis(options.enable_mis, w_camera), 1.0)
    ok = upd & (e_pdf_dir > em.kEpsilon)
    gathered = gathered + torch.where(ok[..., None],
                                      state.throughput * e_value * weight[..., None], 0.0)

  # --- the BSDF sample (before the connections: its lobe routes subsurface) ---
  rng_state, rnd_bsdf = rng.next_n(rng_state, bsdf_dispatch.NUM_SAMPLE_RND)
  bs = bsdf_dispatch.sample(sc, sd, rnd_bsdf, spectral, classes, config.diffuse_variations)

  # --- subsurface: connections, NEE and merging shade at the exit with the
  # white-diffuse exit lobe times the gather weight; a cosine continuation ---
  sss_ok = sss_path = sss_gather = None
  if config.has_subsurface:
    sss_path = (upd & (mat.subsurface_cls != SubsurfaceClass.Disabled)
                & bs.is_reflection & bs.is_diffuse)
    sss_gather, rng_state = sss_mod.gather(sc, sd, trows.mat, pos, rng_state, sss_path, spectral,
                                           config.subsurface_classes)
    sss_ok = sss_path & sss_gather.found
    okn = sss_ok[..., None]
    pos = torch.where(okn, sss_gather.pos, pos)
    nrm = torch.where(okn, sss_gather.nrm, nrm)
    sd = sd._replace(
        w_i=torch.where(okn, sss_gather.w_i, sd.w_i),
        nrm=torch.where(okn, sss_gather.nrm, sd.nrm),
        tan=torch.where(okn, sss_gather.tan, sd.tan),
        btn=torch.where(okn, sss_gather.btn, sd.btn),
        geo_n=torch.where(okn, sss_gather.geo_n, sd.geo_n),
        tex=torch.where(okn, sss_gather.uv, sd.tex))
    rng_state, sss_rnd = rng.next_2d(rng_state)
    sss_dir = em.sample_cosine_distribution_n(sss_rnd, sss_gather.nrm, 1.0)
    sss_pdf = torch.abs(em.dot(sss_dir, sss_gather.nrm)) * em.kInvPi
    bs = bs._replace(
        w_o=torch.where(okn, sss_dir, bs.w_o),
        weight=torch.where(okn, sss_gather.weight, bs.weight),
        pdf=torch.where(sss_ok, sss_pdf, bs.pdf),
        eta=torch.where(sss_ok, 1.0, bs.eta),
        is_delta=torch.where(sss_ok, False, bs.is_delta))

  def sss_override(val, pdf_f, rev, w_o):
    """The white-diffuse exit lobe in place of the camera-side lobe."""
    if not config.has_subsurface:
      return val, pdf_f, rev
    white = em.kInvPi * torch.clamp(em.dot(sd.nrm, w_o), min=0.0)
    val = torch.where(sss_ok[..., None], white[..., None] * sss_gather.weight, val)
    pdf_f = torch.where(sss_ok, white, pdf_f)
    rev = torch.where(sss_ok, em.kInvPi * torch.abs(em.dot(sd.w_i, sd.nrm)), rev)
    return val, pdf_f, rev

  # lanes that cannot connect or merge (no surface, or a delta lobe) get no
  # class: their evaluations return the null result, which no sum reads
  participates = upd & ~bsdf_dispatch.is_delta(sd)
  sd_eval, eval_classes = bsdf_dispatch.restrict(sd, participates, classes)

  # --- next-event estimation ---
  if options.connect_to_light:
    rng_state, rnd_sel = rng.next_float(rng_state)
    rng_state, rnd_em = rng.next_2d(rng_state)
    em_idx, _ = emitters_mod.sample_emitter_index(sc, rnd_sel)
    nee_pos = torch.where(me3, msample.pos, pos) if config.has_media else pos
    esmp = emitters_mod.sample_emitter(sc, em_idx, rnd_em, nee_pos, state.wl, spectral,
                                       config.emitter_classes)
    w_o = esmp.direction
    b_val, b_pdf = bsdf_dispatch.evaluate(sc, sd_eval, w_o, spectral, eval_classes,
                                          config.diffuse_variations)
    rev = b_pdf if options.fast_mis else bsdf_dispatch.reverse_pdf(sc, sd_eval, w_o, spectral,
                                                                   eval_classes)
    b_val, b_pdf, rev = sss_override(b_val, b_pdf, rev, w_o)
    if config.has_media:
      p_nee = media_mod.phase_hg(state.ray_d, w_o, mv.phase_g)
      b_val = torch.where(me3, p_nee[..., None], b_val)
      b_pdf = torch.where(medium_event, p_nee, b_pdf)
      rev = torch.where(medium_event, p_nee, rev)
    sh_o = pt._shading_pos(sd.geo_n, pos, w_o)
    if config.has_media:
      sh_o = torch.where(me3, msample.pos, sh_o)
      tr_nee, rng_state = pt._trace_transmittance(sc, rng_state, state.medium, sh_o,
                                                  esmp.origin, state.wl, spectral)
      occluded = torch.amax(tr_nee, dim=-1) <= 0.0
    else:
      dist = em.length(esmp.origin - sh_o)
      occluded = trace_ops.trace_occluded(sc, sh_o, w_o, eps, dist * (1.0 - 1e-3))
    denom = esmp.pdf_dir * esmp.pdf_sample
    l_dot_e = torch.clamp(torch.abs(em.dot(esmp.direction, esmp.normal)), min=1e-6)
    cam_factor = torch.abs(em.dot(w_o, sd.geo_n))
    vmw_nee = torch.full((r,), vm_weight, device=dev)
    if config.has_media:
      cam_factor = torch.where(medium_event, 1.0, cam_factor)
      vmw_nee = torch.where(medium_event, 0.0, vmw_nee)
    w_light = torch.where(esmp.is_delta, 0.0, b_pdf / torch.clamp(denom, min=1e-20))
    w_cam = ((esmp.pdf_dir_out * cam_factor)
             / torch.clamp(esmp.pdf_dir * l_dot_e, min=1e-20)
             * (vmw_nee + state.d_vcm + state.d_vc * rev))
    weight = _mis(options.enable_mis, w_light, w_cam)
    nee_lane = upd
    if config.has_media:
      nee_lane = upd | (medium_event & mv.explicit_connections)
    ok = (nee_lane & (denom > 0.0) & ~occluded & (b_pdf > 0.0)
          & (state.path_depth + 1 <= config.max_path_length))
    contrib = b_val * esmp.value * (weight / torch.clamp(denom, min=1e-20))[..., None]
    if config.has_media:
      contrib = contrib * tr_nee
    gathered = gathered + torch.where(ok[..., None], state.throughput * contrib, 0.0)
    rays_ct = rays_ct + nee_lane.sum()

  # --- lane-aligned vertex connections ---
  if options.connect_vertices:
    conn_any = participates
    if config.has_media:
      conn_any = participates | (medium_event & mv.explicit_connections)
    # they draw from no lane stream, so skipping them when no lane can
    # connect changes nothing
    if bool(conn_any.any().item()):
      add, n_conn = _connect_vertices(sc, scene, config, options, state, verts, sd, sd_eval,
                                      eval_classes, pos, nrm, upd, medium_event, mv, msample,
                                      sss_ok, sss_gather, vm_weight)
      gathered = gathered + add
      rays_ct = rays_ct + n_conn

  # --- merging (at the subsurface exit where it was substituted) ---
  merged = None
  if options.enable_merging:
    merged = merge_gather(sc, grid, sd_eval, state._replace(ray_o=pos), radius, vc_weight,
                          options, classes, spectral, config.diffuse_variations,
                          exit_mask=sss_ok if config.has_subsurface else None,
                          exit_weight=sss_gather.weight if config.has_subsurface else None,
                          participates=participates)
    merged = torch.where(upd[..., None], merged, 0.0)

  if config.has_media:
    state, rng_state, med_alive = _phase_continue(config, state, mv, msample, medium_event,
                                                  rng_state)
  else:
    med_alive = state.alive

  # --- the continuation on the (possibly subsurface) sample ---
  new_thr = state.throughput * bs.weight
  rng_state, rr_rnd = rng.next_float(rng_state)
  new_depth = state.path_depth + 1
  cont, new_thr = pt._random_continue(new_depth, config.rr_start, state.eta * bs.eta, rr_rnd,
                                      new_thr)
  rev2 = bs.pdf if options.fast_mis else _reverse_pdf_of_sample(sc, sd, bs, upd, spectral,
                                                                 classes)
  if config.has_subsurface:
    # the exit cosine lobe's reverse pdf
    rev2 = torch.where(sss_ok, em.kInvPi * torch.abs(em.dot(sd.w_i, nrm)), rev2)
  surf_alive = (upd & cont & (bs.pdf > 0.0) & (new_depth <= config.max_path_length)
                & (torch.amax(new_thr, dim=-1) > 0.0))
  if config.has_subsurface:
    # a lane that took the subsurface path and found no exit dies here
    surf_alive = surf_alive & ~(sss_path & ~sss_gather.found)
  state = _advance(state, v, bs, sd.geo_n, pos, nrm, new_thr, new_depth, rev2, surf_alive,
                   med_alive, rng_state, rays_ct, vc_weight, vm_weight, gathered=gathered)
  return state, merged


def camera_pass(scene, config, options: VCMOptions, iteration: int, verts: LightVertices,
                grid: Optional[MergeGrid], radius: float, vc_weight: float, vm_weight: float,
                vm_normalization: float, pixel_offset: int = 0, full_height: int | None = None,
                active_mask=None, return_rays: bool = False):
  """Camera paths, one lane per pixel (pixel i connects to light path i).
  Lane i is seeded with tea(i + 0x9E3779B9, iteration) and takes light
  path i's wavelength. Returns the (W*H,3) RGB of the iteration (and, with
  `return_rays`, the rays traced). `active_mask` ((W*H,) bool): lanes
  outside it start dead and return 0. pixel_offset/full_height: the film is
  a band of rows of a larger film; lane i renders pixel i + pixel_offset of
  a film of `full_height` rows, with that pixel's seeds (its light path is
  lane i of `verts`, the band's own slice of the light pass).

  The walk runs to `config.max_path_length` while any lane lives, as a
  cascade of widths n, n/4, ... (at least `_CAMERA_CASCADE_MIN` lanes,
  four at most): when the live lanes fit the next width they are
  compacted, their light vertices with them, and each phase's sums are
  banked by pixel."""
  spectral = config.spectral
  w, h = config.film_width, config.film_height
  r = w * h
  c = spx.channels(spectral)
  dev = scene.tri_v0.device

  if full_height is None:
    full_height = h
  idx = torch.arange(r, dtype=torch.int64, device=dev)
  gidx = idx + pixel_offset
  it_t = torch.full((r,), iteration, dtype=torch.int64, device=dev)
  rng_state = rng.seed(gidx + 0x9E3779B9, it_t)
  rng_state, _ = rng.next_float(rng_state)
  # the light path's wavelength, from its own seed
  _, l_wl_rnd = rng.next_float(rng.seed(gidx, it_t))
  wl = spmod.sample_wavelength(l_wl_rnd) if spectral else torch.zeros(r, device=dev)
  rng_state, jit_rnd = rng.next_2d(rng_state)
  jitter = camera_mod.pixel_jitter(config.pixel_filter, jit_rnd, it_t)
  uv = camera_mod.film_uv(gidx % w, gidx // w, w, full_height, jitter)
  rng_state, lens_rnd = rng.next_2d(rng_state)
  rays = camera_mod.generate_ray(scene.camera, uv, lens_rnd, camera_mod.lens_of(scene.camera),
                                 scene.images, config.equirectangular)
  film_pdf = camera_mod.film_pdf_out(scene.camera, rays.o + rays.d)
  state = VCMState(
      ray_o=rays.o, ray_d=rays.d,
      throughput=torch.ones((r, c), device=dev), gathered=torch.zeros((r, c), device=dev),
      d_vcm=1.0 / torch.clamp(film_pdf, min=1e-20), d_vc=torch.zeros(r, device=dev),
      d_vm=torch.zeros(r, device=dev), eta=torch.ones(r, device=dev),
      medium=scene.camera.medium_index.to(torch.int32).expand(r).contiguous(),
      path_depth=torch.ones(r, dtype=torch.int32, device=dev),
      path_distance=torch.zeros(r, device=dev), rng_state=rng_state, wl=wl,
      alive=torch.ones(r, dtype=torch.bool, device=dev) if active_mask is None else active_mask,
      delta_emitter=torch.zeros(r, dtype=torch.bool, device=dev),
      local_emitter=torch.zeros(r, dtype=torch.bool, device=dev),
      rays_traced=torch.zeros((), dtype=torch.int64, device=dev))

  max_depth = config.max_path_length
  widths = _cascade_widths(r)
  orig = idx
  out_gathered = torch.zeros((r, c), device=dev)
  out_merged = torch.zeros((r, 3), device=dev)
  merged_total = torch.zeros((r, 3), device=dev)
  step = 0
  for li in range(len(widths)):
    last = li == len(widths) - 1
    while step < max_depth and (bool(state.alive.any().item()) if last
                                else state.alive.sum().item() > widths[li + 1]):
      state, merged = _camera_step(scene, config, options, state, verts, grid, radius,
                                   vc_weight, vm_weight)
      if merged is not None:
        merged_total = merged_total + merged
      if config.validate:
        validate.check_finite(
            "vcm:camera_pass", gathered=state.gathered, merged=merged_total,
            throughput=torch.where(state.alive[..., None], state.throughput, 0.0))
      step += 1
    out_gathered.index_add_(0, orig, state.gathered)
    out_merged.index_add_(0, orig, merged_total)
    if last:
      break
    nw = widths[li + 1]
    sel = _alive_first(state.alive)[:nw]
    state = _take(state, sel)._replace(gathered=torch.zeros((nw, c), device=dev))
    merged_total = torch.zeros((nw, 3), device=dev)
    verts = _take(verts, sel)
    orig = orig[sel]

  result = spx.to_film_rgb(out_gathered, wl, spectral) + out_merged * vm_normalization
  if return_rays:
    return result, state.rays_traced
  return result


# ---------------------------------------------------------------------------
# Iterations
# ---------------------------------------------------------------------------


def radius_schedule(scene, config, options: VCMOptions, iteration: int):
  """The merge radius of `iteration` and the MIS weights it gives:
  (radius, vc_weight, vm_weight, vm_normalization) as numpy float32
  scalars, computed on the host in float32 in the JAX package's order (a
  one-ulp change of the radius can move photons between cells)."""
  f32 = np.float32
  w, h = config.film_width, config.film_height
  if options.initial_radius > 0.0:
    radius0 = f32(options.initial_radius)
  else:
    radius0 = f32(5.0) * f32(scene.bsphere_radius.item()) / f32(max(w, h))
  radius = radius0 / (f32(1.0) + f32(iteration) / f32(options.radius_decay))
  eta_vcm = f32(em.kPi) * (radius * radius) * f32(w * h)
  vc_weight = f32(1.0) / eta_vcm
  vm_weight = eta_vcm if options.enable_merging else f32(0.0)
  return radius, vc_weight, vm_weight, f32(1.0) / eta_vcm


def _iteration(scene, config, options: VCMOptions, iteration: int, active=None):
  """One iteration's light pass, grid and camera pass: (the (H,W,3) camera
  RGB, the splat image, the rays traced)."""
  w, h = config.film_width, config.film_height
  radius, vc_weight, vm_weight, vm_norm = (float(x) for x in radius_schedule(
      scene, config, options, iteration))
  verts, splat, l_state = light_pass(scene, config, options, iteration, w * h, vc_weight,
                                     vm_weight)
  grid = None
  if options.enable_merging:
    grid = build_merge_grid(scene, verts, l_state.wl, radius, config.spectral,
                            cell_cap=options.max_photons_per_cell)
  rgb, cam_rays = camera_pass(scene, config, options, iteration, verts, grid, radius, vc_weight,
                              vm_weight, vm_norm, active_mask=active, return_rays=True)
  return rgb.reshape(h, w, 3), splat, l_state.rays_traced + cam_rays


def _on(device, scene, film_state=None):
  device = resolve_device(device)
  scene = st.to_device(scene, device)
  if film_state is not None:
    film_state = film_mod.FilmState(*(x.to(device) for x in film_state))
  return scene, film_state


def render_iteration_stats(scene, config, options: VCMOptions, film_state, iteration: int,
                           device=None):
  """One full iteration (light pass, grid, camera pass, film update) on
  `device` (default: the CUDA card, which must exist). Returns (film_state,
  rays traced: closest-hit and occlusion rays of both passes, as a 0-d
  int64 tensor)."""
  scene, film_state = _on(device, scene, film_state)
  colors, splat, rays = _iteration(scene, config, options, iteration)
  film_state = film_mod.commit_light_iteration(
      film_state._replace(light_iteration=film_state.light_iteration + splat))
  zero = torch.zeros_like(colors)
  return film_mod.accumulate_camera(film_state, colors, zero, zero), rays


def render_iteration(scene, config, options: VCMOptions, film_state, iteration: int,
                     device=None):
  """`render_iteration_stats` without the ray count."""
  return render_iteration_stats(scene, config, options, film_state, iteration, device)[0]


def render_chunk(scene, config, options: VCMOptions, film_state, first_iteration: int,
                 num_iterations: int, device=None):
  """`num_iterations` iterations from `first_iteration`, one after another."""
  for k in range(num_iterations):
    film_state = render_iteration(scene, config, options, film_state, first_iteration + k,
                                  device)
  return film_state


def render_chunk_stats(scene, config, options: VCMOptions, film_state, first_iteration: int,
                       num_iterations: int, device=None):
  """`render_chunk` and the rays traced in all its iterations."""
  rays = 0
  for k in range(num_iterations):
    film_state, r = render_iteration_stats(scene, config, options, film_state,
                                           first_iteration + k, device)
    rays = rays + r
  return film_state, rays


def render(scene, config, options: VCMOptions | None = None, iterations: int | None = None,
           device=None) -> film_mod.FilmState:
  """Render `iterations` iterations (default: config.samples) on `device`
  (default: the CUDA card, which must exist)."""
  options = options or VCMOptions()
  n = config.samples if iterations is None else iterations
  device = resolve_device(device)
  scene, _ = _on(device, scene)
  fs = film_mod.allocate(config.film_width, config.film_height, device)
  for i in range(n):
    fs = render_iteration(scene, config, options, fs, i, device)
  return fs


def render_adaptive(scene, config, options: VCMOptions | None = None,
                    max_iterations: int | None = None, min_samples: int = 32, device=None):
  """Progressive render with adaptive camera passes: after `min_samples`
  full iterations, pixels whose noise estimate is below
  `config.noise_threshold` (grown to 5x5 blocks of unconverged pixels)
  stop taking camera paths, while the light pass still splats everywhere;
  the render stops when no pixel is left. Returns (film_state, the (H,W)
  camera samples per pixel)."""
  options = options or VCMOptions()
  n = config.samples if max_iterations is None else max_iterations
  w, h = config.film_width, config.film_height
  device = resolve_device(device)
  scene, _ = _on(device, scene)
  fs = film_mod.allocate(w, h, device)
  warm = min(min_samples, n)
  for i in range(warm):
    fs = render_iteration(scene, config, options, fs, i, device)
  counts = torch.full((h, w), float(warm), device=device)
  for i in range(warm, n):
    active = film_mod.dilate_mask(film_mod.noise_estimate(fs) > config.noise_threshold)
    if not bool(active.any().item()):
      break
    colors, splat, _ = _iteration(scene, config, options, i, active=active.reshape(-1))
    fs = film_mod.commit_light_iteration(fs._replace(light_iteration=fs.light_iteration + splat))
    fs, counts = film_mod.accumulate_camera_masked(fs, colors, counts, active)
  return fs, counts
