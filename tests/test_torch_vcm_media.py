"""The port's BDPT and VCM with media and subsurface scattering against the
JAX package (CPU): BDPT on bench config 4's heterogeneous cloud (light and
camera walks with free-path sampling, connections through transmittance
walks, the vertex connections as one (R*V)-wide walk seeded per slot), and
VCM and BDPT on test_sss_render's random-walk subsurface Cornell box
(camera-side connections, NEE and merging at the exit).

Each render is held to the JAX package's jitted render pixel by pixel from
iteration FIRST, as tests/test_torch_media.py does and for its reason
(iteration 0's pixel-centre rays on the film's diagonals meet the room's
corner edges, and with media a changed hit changes a loop's trip count and
with it every lane's stream): at most OUTLIER_FRACTION of the pixels off by
more than 1e-4 + 1e-3 |ref| and the image mean within MEAN_RTOL, the
subsurface renders at tests/test_torch_subsurface.py's random-walk
tolerances (its walks part from the jitted JAX code on a few lanes), and
the rays traced within RAYS_RTOL. VCM merges with a cap above every
cell's occupancy, as in tests/test_torch_vcm.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import scenes as jscenes
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu_torch.models import vcm as pvcm
from etx_tracer_tpu_torch.ops import brute_trace
from etx_tracer_tpu_torch.scene import volumetric as pvol
from tests.test_torch_subsurface import RW, RW_MEAN_RTOL, RW_OUTLIER_FRACTION, _jax_subsurface
from tests.test_torch_vcm import FILM, RAYS_RTOL, SPP, UNCAPPED, _render_pair
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FIRST = 1                  # the renders' first iteration (see above)
MPL = 6                    # the cloud's path length here
OUTLIER_FRACTION = 0.02    # the cloud: pixels off by > 1e-4 + 1e-3 |ref|
MEAN_RTOL = 0.005          # the cloud: image mean


@pytest.fixture(scope="module")
def cache_home(tmp_path_factory):
  """A per-user cache of the module's own for the cloud's `.vol` file."""
  home = tmp_path_factory.mktemp("cache")
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("XDG_CACHE_HOME", str(home))
    yield home


@pytest.fixture(scope="module")
def scenes(cache_home):
  """{name: ((JAX scene, config), (port scene, config))}."""
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    jb, pb = jscenes.volumetric(FILM), pvol.volumetric(FILM)
    jb.max_path_length = pb.max_path_length = MPL
    out["cloud"] = (jb.build(), pb.build(device="cpu"))
    out["subsurface"] = (_jax_subsurface(FILM, RW).build(),
                         pvol.subsurface_cornell(FILM, RW).build(device="cpu"))
  return out


def _check(img, ref, rays, ref_rays, outlier_fraction, mean_rtol):
  assert img.shape == ref.shape == (FILM[1], FILM[0], 3)
  assert np.isfinite(img).all() and (img >= 0.0).all()
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.mean() <= outlier_fraction, outliers.mean()
  assert abs(img.mean() - ref.mean()) <= mean_rtol * abs(ref.mean()), (img.mean(), ref.mean())
  assert rays == pytest.approx(ref_rays, rel=RAYS_RTOL)
  third = FILM[0] // 3
  left, right = img[:, :third].mean((0, 1)), img[:, -third:].mean((0, 1))
  assert left[0] > left[1] and right[1] > right[0]


def test_cloud_bdpt_matches_jax_pixel_by_pixel(scenes):
  (jscene, jconfig), (pscene, pconfig) = scenes["cloud"]
  assert pconfig.has_media and not pconfig.has_subsurface and pconfig.max_path_length == MPL
  before = dict(brute_trace.launches)
  img, ref, rays, ref_rays = _render_pair(jscene, jconfig, pscene, pconfig, pvcm.bdpt_options(),
                                          FIRST, SPP)
  assert brute_trace.launches == before  # the plain versions on the CPU
  _check(img, ref, rays, ref_rays, OUTLIER_FRACTION, MEAN_RTOL)


@pytest.mark.parametrize("mode", ["vcm", "bdpt"])
def test_subsurface_vcm_and_bdpt_match_jax_pixel_by_pixel(scenes, mode):
  (jscene, jconfig), (pscene, pconfig) = scenes["subsurface"]
  assert pconfig.has_subsurface and not pconfig.has_media
  options = (dataclasses.replace(pvcm.VCMOptions(), max_photons_per_cell=UNCAPPED) if mode == "vcm"
             else pvcm.bdpt_options())
  img, ref, rays, ref_rays = _render_pair(jscene, jconfig, pscene, pconfig, options, FIRST, SPP)
  _check(img, ref, rays, ref_rays, RW_OUTLIER_FRACTION, RW_MEAN_RTOL)
