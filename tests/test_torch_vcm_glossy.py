"""The port's VCM on non-diffuse surfaces against the JAX package (CPU).

The Cornell box with its smooth conductor tall box (`diffuse_only=False`,
path length 5): a delta surface, where light paths store no vertex and
camera paths do not merge; the render is held to the JAX package's jitted
render pixel by pixel, as in tests/test_torch_vcm.py (merging with a cap
above every cell's occupancy, for the reason given there).

On that box the merge's glossy pass (the BSDF dispatch, photon by photon)
never runs: no lane that merges is rough and not Diffuse. So
`merge_gather` is also held alone, on the JAX package's light vertices and
capped grid of the same box with a rough tall box (roughness ROUGHNESS,
staged by the same steps in both packages), with query lanes on that
conductor and on the diffuse walls, so that both the Lambert and the
glossy pass run: within PASS_RTOL relative (PASS_ATOL absolute).

`dispatch.restrict`, which narrows the VCM passes' BSDF dispatches to the
lanes whose results are read, is held on the rough box's camera hits: the
kept lanes' results bit-equal to the full dispatch's, the null result
elsewhere.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.models import vcm as jvcm
from etx_tracer_tpu.render.bsdf.lobes import ShadingData as JShadingData
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.scene import packed as jpacked
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.models import vcm as pvcm
from etx_tracer_tpu_torch.ops import trace as ptrace
from etx_tracer_tpu_torch.render import camera as pcamera
from etx_tracer_tpu_torch.render.bsdf import dispatch as pdispatch
from etx_tracer_tpu_torch.render.bsdf.lobes import ShadingData as PShadingData
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.scene import packed as ppacked
from etx_tracer_tpu_torch.scene.types import MaterialClass as MC
from tests.test_torch_vcm import (FILM, PASS_ATOL, PASS_RTOL, SPP, UNCAPPED, _render_pair, _t,
                                  check_render)
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

MPL = 5           # the conductor box's path length
ROUGHNESS = 0.3   # the rough tall box of the merge_gather test
ITERATION = 1


def _builders(rough: bool):
  """(JAX builder, port builder) of the conductor-box Cornell, its tall box
  rough or smooth."""
  pair = tuple(m.build_cornell_box(film_size=FILM, diffuse_only=False, max_path_length=MPL)
               for m in (jcornell, pcornell))
  if rough:
    for b in pair:
      i = b.material_names["tallBox"]
      b.materials[i] = dataclasses.replace(b.materials[i], roughness=(ROUGHNESS, ROUGHNESS))
  return pair


@pytest.fixture(scope="module")
def scenes():
  """{rough: ((JAX scene, config), (port scene, config))}."""
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    for rough in (False, True):
      jb, pb = _builders(rough)
      out[rough] = (jb.build(), pb.build(device="cpu"))
  return out


def test_conductor_box_vcm_matches_jax(scenes, monkeypatch):
  (jscene, jconfig), (pscene, pconfig) = scenes[False]
  assert pconfig.material_classes == (MC.Diffuse, MC.Conductor)
  tall = int(np.flatnonzero(pscene.mat_table[:, 0].numpy() == MC.Conductor)[0])

  # light paths store no vertex on the delta tall box
  _, vcw, vmw, _ = (float(x) for x in pvcm.radius_schedule(pscene, pconfig, pvcm.VCMOptions(),
                                                           ITERATION))
  verts, _, _ = pvcm.light_pass(pscene, pconfig, pvcm.VCMOptions(), ITERATION, 256, vcw, vmw)
  assert verts.valid.any() and not (verts.valid & (verts.mat == tall)).any()

  # camera lanes on it do not merge: they reach the merge with no class
  seen = []
  merge = pvcm.merge_gather

  def spy(scene, grid, sd, state, *args, **kwargs):
    out = merge(scene, grid, sd, state, *args, **kwargs)
    seen.append((sd.mat.cls.clone(), out.clone()))
    return out

  monkeypatch.setattr(pvcm, "merge_gather", spy)
  options = dataclasses.replace(pvcm.VCMOptions(), max_photons_per_cell=UNCAPPED)
  img, ref, rays, ref_rays = _render_pair(jscene, jconfig, pscene, pconfig, options, 0, SPP)
  check_render(img, ref, rays, ref_rays)
  assert (img >= 0.0).all()
  assert seen and all(not (cls == MC.Conductor).any() for cls, _ in seen)
  assert all(float(out[cls < 0].abs().sum()) == 0.0 for cls, out in seen)
  assert any(float(out.abs().max()) > 0.0 for _, out in seen)


def _camera_hits(pscene):
  """The first hits of the pixel-centre camera rays: (rays, positions,
  material rows (numpy), the other ShadingData fields)."""
  w, h = FILM
  idx = torch.arange(w * h)
  uv = pcamera.film_uv(idx % w, idx // w, w, h, torch.zeros(w * h, 2))
  rays = pcamera.generate_ray(pscene.camera, uv)
  hit = ptrace.trace_closest(pscene, rays.o, rays.d, rays.t_min, rays.t_max)
  pos, nrm, tan, btn, uvt, _, _, trows = ppt._interpolate_hit(pscene, hit)
  fields = dict(w_i=rays.d, nrm=nrm, tan=tan, btn=btn, geo_n=trows.geo_n, tex=uvt,
                wl=torch.zeros(w * h), medium=torch.full((w * h,), -1, dtype=torch.int32))
  return rays, pos, pscene.mat_table[trows.mat].numpy(), fields


@pytest.mark.parametrize("keep", ["conductor lanes", "every other lane"])
def test_restrict_dispatches_only_the_read_lanes(scenes, keep):
  """`dispatch.restrict` on the rough box's camera hits: every kept lane
  gets from evaluate, pdf, reverse_pdf and sample exactly what the full
  dispatch gives it, every other lane the null result, and only the
  classes of the kept lanes are dispatched."""
  (_, _), (pscene, pconfig) = scenes[True]
  classes = pconfig.material_classes
  _, _, mat_rows, fields = _camera_hits(pscene)
  sd = PShadingData(mat=ppacked.MaterialRows(_t(mat_rows)), **fields)
  cls = mat_rows[:, 0]
  n = cls.shape[0]
  lanes = cls == MC.Conductor if keep == "conductor lanes" else np.arange(n) % 2 == 0
  rng = np.random.default_rng(51)
  w_o = rng.normal(size=(n, 3)).astype(np.float32)
  w_o = _t(w_o / np.linalg.norm(w_o, axis=1, keepdims=True))
  rnd = _t(rng.uniform(size=(n, pdispatch.NUM_SAMPLE_RND)).astype(np.float32))

  sd_r, held = pdispatch.restrict(sd, _t(lanes), classes)
  assert held == tuple(c for c in classes if (cls[lanes] == c).any())
  assert held == ((MC.Conductor,) if keep == "conductor lanes" else classes)
  keep_t = _t(lanes)
  for name, full, part in (
      ("evaluate", pdispatch.evaluate(pscene, sd, w_o, False, classes),
       pdispatch.evaluate(pscene, sd_r, w_o, False, held)),
      ("pdf", (pdispatch.pdf(pscene, sd, w_o, False, classes),),
       (pdispatch.pdf(pscene, sd_r, w_o, False, held),)),
      ("reverse_pdf", (pdispatch.reverse_pdf(pscene, sd, w_o, False, classes),),
       (pdispatch.reverse_pdf(pscene, sd_r, w_o, False, held),)),
      ("sample", pdispatch.sample(pscene, sd, rnd, False, classes)[1:3],
       pdispatch.sample(pscene, sd_r, rnd, False, held)[1:3])):
    for a, b in zip(full, part):
      assert torch.equal(a[keep_t], b[keep_t]), name
      assert not b[~keep_t].any(), name
  assert (pdispatch.pdf(pscene, sd, w_o, False, classes)[keep_t] > 0).any()


def test_merge_gather_glossy_and_lambert_match_jax(scenes):
  (jscene, jconfig), (pscene, pconfig) = scenes[True]
  classes = pconfig.material_classes
  o = pvcm.VCMOptions()
  radius, vcw, vmw, _ = (float(x) for x in pvcm.radius_schedule(pscene, pconfig, o, ITERATION))
  jverts, _, jstate = jvcm.light_pass(jscene, jconfig, jvcm.VCMOptions(), ITERATION, 256,
                                      jnp.float32(vcw), jnp.float32(vmw))
  jgrid = jvcm.build_merge_grid(jscene, jverts, jstate.wl, jnp.float32(radius), False, 16)
  grid = pvcm.MergeGrid(
      sorted_cell=_t(jgrid.sorted_cell).to(torch.int64), pos=_t(jgrid.pos), nrm=_t(jgrid.nrm),
      w_i=_t(jgrid.w_i), d_vcm=_t(jgrid.d_vcm), d_vm=_t(jgrid.d_vm),
      path_length=_t(jgrid.path_length), throughput_rgb=_t(jgrid.throughput_rgb),
      valid=_t(jgrid.valid), grid_min=_t(jgrid.grid_min), cell_size=float(jgrid.cell_size),
      rows=_t(jgrid.rows), cell_cap=jgrid.cell_cap)

  # query lanes: the first hits of the pixel-centre camera rays
  rays, pos, mat_rows, fields = _camera_hits(pscene)
  rng = np.random.default_rng(50)
  n = FILM[0] * FILM[1]
  d_vcm = rng.uniform(0.05, 2.0, n).astype(np.float32)
  d_vm = rng.uniform(0.05, 2.0, n).astype(np.float32)
  thr = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
  cls = mat_rows[:, 0]
  assert (cls == MC.Conductor).sum() > 10 and (cls == MC.Diffuse).sum() > 10
  assert (mat_rows[cls == MC.Conductor, ppacked.mat_column("roughness")] == ROUGHNESS).all()

  psd = PShadingData(mat=ppacked.MaterialRows(_t(mat_rows)), **fields)
  jsd = JShadingData(mat=jpacked.unpack_material_rows(jnp.asarray(mat_rows)),
                     **{k: jnp.asarray(v.numpy()) for k, v in fields.items()})

  def state(mod, a):
    z = a(np.zeros(n, np.float32))
    return mod.VCMState(ray_o=a(pos.numpy()), ray_d=a(rays.d.numpy()), throughput=a(thr),
                        gathered=a(np.zeros((n, 3), np.float32)), d_vcm=a(d_vcm), d_vc=z,
                        d_vm=a(d_vm), eta=z, medium=a(np.full(n, -1, np.int32)),
                        path_depth=a(np.ones(n, np.int32)), path_distance=z,
                        rng_state=a(np.zeros(n, np.int64)), wl=z, alive=a(np.ones(n, bool)),
                        delta_emitter=a(np.zeros(n, bool)), local_emitter=a(np.zeros(n, bool)),
                        rays_traced=a(np.zeros((), np.int64)))

  got = pvcm.merge_gather(pscene, grid, psd, state(pvcm, _t), radius, vcw, o, classes, False)
  want = jvcm.merge_gather(jscene, jgrid, jsd, state(jvcm, jnp.asarray), jnp.float32(radius),
                           jnp.float32(vcw), jvcm.VCMOptions(), classes, False)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PASS_RTOL, atol=PASS_ATOL)
  out = got.numpy().sum(axis=-1)
  assert (out[cls == MC.Conductor] > 0).mean() > 0.1   # the glossy pass
  assert (out[cls == MC.Diffuse] > 0).mean() > 0.5     # the Lambert pass
