"""The port's VCM family under distant emitters against the JAX package
(CPU): full VCM and BDPT renders of the environment-lit floor
(`scene/atmosphere.env_floor_scene`, the JAX package's image test scene),
whose light paths all start on the bounding sphere from the environment and
whose camera paths gather it where they miss.

Both packages freeze the same scene (the JAX tree by its numpy builder, the
bank by its native alias builder). Renders are held to the JAX package's
jitted render pixel by pixel at tests/test_torch_vcm.py's tolerances,
merging with a photon cap above every cell's occupancy (see there).
"""

import dataclasses

import numpy as np
import pytest
import torch

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu_torch.models import vcm as pvcm
from etx_tracer_tpu_torch.scene import atmosphere as patm
from tests.test_torch_images import load_native, render_builders
from tests.test_torch_vcm import FILM, SPP, UNCAPPED, _render_pair, check_render
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
  """((JAX scene, config), (port scene, config)) of the 16x16 env-lit floor."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    load_native()
    jb, pb, _ = render_builders("env floor", FILM)
    return jb.build(), pb.build(device="cpu")


@pytest.mark.parametrize("mode", ["vcm", "bdpt"])
def test_env_floor_matches_jax_pixel_by_pixel(scene, mode):
  (jscene, jconfig), (pscene, pconfig) = scene
  assert pconfig.num_env_emitters == 1 and pconfig.emitter_classes == (1,)
  options = pvcm.VCMOptions() if mode == "vcm" else pvcm.bdpt_options()
  options = dataclasses.replace(options, max_photons_per_cell=UNCAPPED)
  img, ref, rays, ref_rays = _render_pair(jscene, jconfig, pscene, pconfig, options, 0, SPP)
  check_render(img, ref, rays, ref_rays)
  assert (img >= 0.0).all() and img.mean() > 0.05
  # the map is orange: red above blue on the floor and in the sky
  assert img[..., 0].mean() > img[..., 2].mean()


def test_light_paths_start_on_the_bounding_sphere(scene):
  """Every light path of the env-lit floor is distant: it starts on the
  scene's bounding sphere, heading inward."""
  pscene, pconfig = scene[1]
  n = FILM[0] * FILM[1]
  state = pvcm._generate_light_state(pscene, pconfig, n, 1, 1e-3)
  assert not state.local_emitter.any() and not state.delta_emitter.any()
  r = (state.ray_o - pscene.bsphere_center).norm(dim=-1)
  np.testing.assert_allclose(r.numpy(), float(pscene.bsphere_radius), rtol=1e-4)
  inward = (state.ray_d * (pscene.bsphere_center - state.ray_o)).sum(-1)
  assert (inward.numpy() >= 0.0).all()
  assert patm.env_floor_scene().max_path_length == 3
