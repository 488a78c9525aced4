"""The port's atmosphere precompute and bench config 3 against the JAX
package (CPU).

The optical-length LUT, the sky image and the sun image are float64 numpy
in both packages, the same operations on the same tables: they must be
bit-equal (at small sizes: the bench's 256x128 sky takes seconds of
numpy). So must the frozen scene of `atmosphere_scene` with a small sky:
its emitter and profile tables, its image bank (the JAX bank built by the
JAX package's native alias builder), its thin-lens camera and its
configuration. Then bench config 3 at 16x16, spectral, 4 spp, is held to
the JAX package's jitted render pixel by pixel at
tests/test_torch_render.py's tolerances: the sky's lookups and the sun's
disk test go through atan2, asin, sin and cos, which XLA and PyTorch may
round apart.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import scenes as jscenes
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.scene import atmosphere as jatm
from etx_tracer_tpu_torch.core import spectrum as pspectrum
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.scene import atmosphere as patm
from etx_tracer_tpu_torch.scene import types as ptypes
from tests.test_torch_images import load_native
from tests.test_torch_render import _jax_arrays
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FILM, SPP = (16, 16), 4      # the whole-render comparison
SKY = (32, 16)               # the small sky of the scene comparisons
SUN_DIRECTION = (0.3, 0.6, 0.5)
OUTLIER_FRACTION = 0.02      # whole render: pixels off by > 1e-4 + 1e-3 |ref|
MEAN_RTOL = 0.005            # whole render: image mean


def _jax_builder(size):
  """benchmarks/scenes.py:atmosphere_scene with the small sky."""
  add = jatm.add_atmosphere

  def small_sky(b, direction=(0.0, 0.866, 0.5), **kw):
    return add(b, direction=direction, **{**kw, "sky_size": SKY})

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jatm, "add_atmosphere", small_sky)
    return jscenes.atmosphere_scene(size)


@pytest.fixture(scope="module")
def scenes():
  """((JAX scene, config), (port scene, config), port arrays) of bench
  config 3 at 16x16 with the small sky."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    load_native()
    jb, pb = _jax_builder(FILM), patm.atmosphere_scene(FILM, sky_size=SKY)
    return jb.build(), pb.build(device="cpu"), pb.arrays()[0]


def test_spectrum_tables_equal_jax():
  """What the precompute reads of the spectrum module."""
  from etx_tracer_tpu.core import spectrum as jspectrum
  np.testing.assert_array_equal(pspectrum.GRID, jspectrum.GRID)
  assert pspectrum.Y_INTEGRAL == jspectrum.Y_INTEGRAL
  np.testing.assert_array_equal(pspectrum.XYZ_TO_RGB, jspectrum.XYZ_TO_RGB)
  wl = pspectrum.GRID[::5]
  np.testing.assert_array_equal(pspectrum._xyz_bar_np(wl), jspectrum._xyz_bar_np(wl))


@pytest.mark.parametrize("size", [8, 32])
def test_optical_length_lut_equals_jax(size):
  got = patm.build_optical_length_lut(size)
  assert got.shape == (size, size, 3) and got.dtype == np.float32
  np.testing.assert_array_equal(got, jatm.build_optical_length_lut(size))


@pytest.mark.parametrize("case", ["bench sun", "default sun, hazy", "low sun"])
def test_sky_and_sun_images_equal_jax(case):
  direction, params = {
      "bench sun": (SUN_DIRECTION, {}),
      "default sun, hazy": ((0.0, 0.866, 0.5), {"anisotropy": 0.6, "mie_scale": 3.0}),
      "low sun": ((1.0, 0.05, 0.2), {"altitude": 500.0, "ozone_scale": 0.5}),
  }[case]
  lut = jatm.build_optical_length_lut(16)
  got = patm.generate_sky_image(patm.Parameters(**params), SKY, direction, lut)
  want = jatm.generate_sky_image(jatm.Parameters(**params), SKY, direction, lut)
  assert got.shape == (SKY[1], SKY[0], 4) and np.isfinite(got).all()
  np.testing.assert_array_equal(got, want)
  got = patm.generate_sun_image(patm.Parameters(**params), (16, 16), direction, np.deg2rad(0.53))
  want = jatm.generate_sun_image(jatm.Parameters(**params), (16, 16), direction,
                                 np.deg2rad(0.53))
  np.testing.assert_array_equal(got, want)
  assert got[..., :3].max() > 0.0


def test_scene_tables_equal_jax(scenes):
  (jscene, jconfig), (pscene, pconfig), arrays = scenes
  want = _jax_arrays(jscene)
  for name, v in arrays.items():
    if not name.startswith("bvh."):
      np.testing.assert_array_equal(np.asarray(v), want[name], err_msg=name)
  for f in dataclasses.fields(ptypes.SceneConfig):
    assert getattr(pconfig, f.name) == getattr(jconfig, f.name), f.name
  # the sky and the sun, each weighing its luminance over the sphere's disk
  np.testing.assert_array_equal(pscene.em_table[:, 0].numpy(), [1, 2])
  assert float(pscene.em_table[0, 3]) == float(pscene.em_table[1, 3]) > 0.0
  np.testing.assert_array_equal(pscene.emitters.env_indices.numpy()[:3], [0, 1, -1])
  # padded to the 64x64 sun
  assert pscene.images.pixels.shape == (2, 64, 64, 4)


def test_bench_configuration():
  """Bench config 3 as `chip_smoke.py` stages it (small sky here): 12
  Diffuse triangles, spectral, path length 8, the sky and the sun, a thin
  lens without an aperture image, deferred NEE."""
  b = patm.atmosphere_scene((512, 512), sky_size=SKY)
  arrays, config = b.arrays()
  assert arrays["tri_v0"].shape == (patm.NUM_TRIANGLES, 3)
  assert (config.film_width, config.film_height, config.spectral) == (512, 512, True)
  assert config.max_path_length == 8 and config.material_classes == (0,)
  assert config.emitter_classes == (1, 2) and config.num_env_emitters == 2
  assert config.has_images and not config.equirectangular
  assert ppt.uses_deferred_nee(config)
  assert float(arrays["camera.lens_radius"]) == pytest.approx(0.02)
  assert float(arrays["camera.focal_distance"]) == pytest.approx(5.5)
  assert int(arrays["camera.lens_image"]) == -1


def test_render_matches_jax_pixel_by_pixel(scenes):
  (jscene, jconfig), (pscene, pconfig), _ = scenes
  pool = FILM[0] * FILM[1] * SPP
  sums, rays = jpt.render_samples_static(jscene, jconfig, 0, SPP, pool_size=pool)
  ref = np.asarray(jpt.finalize_film(sums, SPP, FILM[0]).camera)
  psums, prays = ppt.render_samples_static(pscene, pconfig, 0, SPP, pool_size=pool,
                                           device="cpu")
  img = ppt.finalize_film(psums, SPP, FILM[0]).camera.numpy()
  assert np.isfinite(img).all()
  y = img.astype(np.float64) @ pspectrum.RGB_TO_XYZ[1]
  assert y.min() >= -1e-6 and y.mean() > 0.05
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.mean() <= OUTLIER_FRACTION, outliers.mean()
  assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())
  np.testing.assert_array_equal(psums.table[:, 12].numpy(), np.asarray(sums.table)[:, 12])
  assert int(prays) == pytest.approx(float(rays), rel=0.005)
