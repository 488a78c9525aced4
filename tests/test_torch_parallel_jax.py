"""The port's sharded renderers against the JAX package's (CPU): the
3-rank pooled render against `etx_tracer_tpu.parallel.render_samples_sharded`
on three virtual CPU devices (film and ray count), and both VCM passes
with their sharding parameters on one band of an uneven film. The JAX
sharded VCM is not compiled here (its test takes minutes); the port's is
held against its single-device VCM in `test_torch_parallel.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu import parallel as jparallel
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.models import vcm as jvcm
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.models import vcm as pvcm
from etx_tracer_tpu_torch.parallel import mesh as pmesh
from etx_tracer_tpu_torch.scene import cornell as pcornell
from tests.test_torch_parallel import FILM, MPL, POOL, PT_ATOL, PT_RTOL, SPP, VCM_ATOL, \
    VCM_RTOL, _cornell, _gloo
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

# the JAX package's render_samples_sharded on a 3-device virtual mesh at
# FILM, SPP and POOL counts the padded row's rays too
JAX_SHARDED_RAYS = 1854
SINGLE_RAYS = 1731


def test_three_ranks_match_the_jax_sharded_render(monkeypatch):
  """The 3-rank film and ray count against the JAX package's
  render_samples_sharded on three virtual CPU devices."""
  pt_scene = _cornell(FILM)
  pt_sharded3 = _gloo(pmesh.render_samples_job, 3, *pt_scene, 0, SPP, POOL)
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
  scene, config = jcornell.build_cornell_box(film_size=FILM, diffuse_only=True,
                                             max_path_length=MPL).build()
  mesh = jparallel.make_mesh(jax.devices()[:3])
  sums, rays = jparallel.render_samples_sharded(jparallel.mesh.replicate_scene(scene, mesh),
                                                config, 0, SPP, mesh, pool_size=POOL)
  want = np.asarray(jpt.finalize_film(sums, SPP, FILM[0]).camera)
  assert int(rays) == JAX_SHARDED_RAYS == pt_sharded3[0]["rays_total"]
  got = ppt.finalize_film(ppt.FilmSums(torch.from_numpy(pt_sharded3[0]["table"])), SPP,
                          FILM[0]).camera.numpy()
  np.testing.assert_allclose(got, want, rtol=PT_RTOL, atol=PT_ATOL)
  # the single-device render counts no padded row
  _, single_rays = ppt.render_samples_static(*pt_scene, 0, SPP, pool_size=POOL, device="cpu")
  assert int(single_rays) == SINGLE_RAYS


@pytest.fixture(scope="module")
def band_scenes():
  """The diffuse Cornell box at FILM in both packages (JAX tree by the
  numpy builder)."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    kw = dict(film_size=FILM, diffuse_only=True, max_path_length=5)
    return jcornell.build_cornell_box(**kw).build(), pcornell.build_cornell_box(**kw).build(
        device="cpu")


def test_vcm_band_passes_match_jax(band_scenes):
  """The last band of three (rows 8-11 of 11, one padded) through both
  passes with the sharding parameters: the light pass's vertices, splat
  image and states, then the camera pass on the JAX package's vertices and
  a grid of them."""
  (jscene, jconfig), (pscene, pconfig) = band_scenes
  w, h = FILM
  world, rank, it = 3, 2, 1
  local_h = pmesh.band_height(h, world)
  offset, n_paths = rank * local_h * w, local_h * w
  o = pvcm.VCMOptions()
  radius, vcw, vmw, vmn = (float(x) for x in pvcm.radius_schedule(pscene, pconfig, o, it))
  jband = dataclasses.replace(jconfig, film_height=local_h)
  pband = dataclasses.replace(pconfig, film_height=local_h)
  shape = (local_h * world, h)
  verts, splat, state = pvcm.light_pass(pscene, pband, o, it, n_paths, vcw, vmw,
                                        path_offset=offset, n_valid=w * h, splat_shape=shape)
  jverts, jsplat, jstate = jvcm.light_pass(jscene, jband, jvcm.VCMOptions(), it, n_paths,
                                           jnp.float32(vcw), jnp.float32(vmw), path_offset=offset,
                                           n_valid=w * h, splat_shape=shape)
  assert splat.shape == (12, w, 3)
  np.testing.assert_array_equal(state.rng_state.numpy().astype(np.uint32),
                                np.asarray(jstate.rng_state))
  assert int(state.rays_traced) == int(jstate.rays_traced)
  for f in pvcm.LightVertices._fields:
    np.testing.assert_allclose(getattr(verts, f).numpy().astype(np.float64),
                               np.asarray(getattr(jverts, f)).astype(np.float64),
                               rtol=VCM_RTOL, atol=VCM_ATOL, err_msg=f)
  # the padded row's light paths start dead and store nothing
  assert not verts.valid[(h - rank * local_h) * w:].any() and verts.valid.any()
  np.testing.assert_allclose(splat.numpy(), np.asarray(jsplat), rtol=PT_RTOL, atol=PT_ATOL)
  assert (splat.numpy() != 0).any()

  carried = pvcm.LightVertices(*(torch.from_numpy(np.array(x)) for x in jverts))
  grid = pvcm.build_merge_grid(pscene, carried, torch.from_numpy(np.array(jstate.wl)), radius,
                               False, 16)
  jgrid = jvcm.build_merge_grid(jscene, jverts, jstate.wl, jnp.float32(radius), False, 16)
  got, rays = pvcm.camera_pass(pscene, pband, o, it, carried, grid, radius, vcw, vmw, vmn,
                               pixel_offset=offset, full_height=h, return_rays=True)
  want, wrays = jvcm.camera_pass(jscene, jband, jvcm.VCMOptions(), it, jverts, jgrid,
                                 *(jnp.float32(x) for x in (radius, vcw, vmw, vmn)),
                                 pixel_offset=offset, full_height=h, return_rays=True)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PT_RTOL, atol=PT_ATOL)
  assert int(rays) == int(wrays)
  assert (got.numpy() != 0).any(axis=-1).mean() > 0.5
