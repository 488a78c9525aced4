"""Showcase subset A rendered by the port and by the JAX package (CPU).

The classes of the all-classes showcase (`tests/shading_showcase.py`)
are split over three subset scenes, staged by the same helper, so that
each file compiles one or two JAX renders and stays within its time:
subset A holds the Principled sphere (metalness, roughness and normal-map
images, transmission 0.3) and the Void, in the spectral Cornell box with
its conductor tall box and a white-LED light, at icosphere order 1 (80
triangles a sphere: the pair-tile plain versions on the port's side).
Subset B (Velvet, Translucent, the diffuse variations) is
test_torch_showcase_b.py's, subset C (the textured Plastic, the Mirror,
the alpha-cut Diffuse) and the specular-box Cornell
test_torch_showcase_c.py's; they share this file's helpers.

Both packages stage the scene through their own builders (tables equal);
each renders iterations 1-4 at 16x16 with the same pool. Iteration 0's
pixel-centre rays meet the room's corner edges and round apart (as in the
media tests), and the alpha test draws from every lane's stream, so the
renders start from iteration 1. Pixels are held by the tests' outlier
threshold, > 1e-4 + 1e-3 |ref|.
"""

import dataclasses

import numpy as np
import pytest
import torch

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.core import spectrum as jspectrum
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.scene import builder as jbuilder
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.scene import spectral_data as jsdata
from etx_tracer_tpu.scene import types as jtypes
from etx_tracer_tpu_torch.core import spectrum as pspectrum
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.scene import builder as pbuilder
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.scene import spectral_data as psdata
from etx_tracer_tpu_torch.scene import types as ptypes
from tests import shading_showcase
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FILM, FIRST, SPP, POOL = (16, 16), 1, 4, 1024
SUBSET = ("principled", "void")
OUTLIERS = 0          # pixels off by more than 1e-4 + 1e-3 |ref|
MEAN_RTOL = 1e-4      # image means


def _jax_arrays(scene):
  out = {}
  for name, v in scene._asdict().items():
    if name == "spec_at_wl":
      continue
    if isinstance(v, tuple):
      out.update({f"{name}.{f}": np.asarray(x) for f, x in v._asdict().items()
                  if x is not None})
    else:
      out[name] = np.asarray(v)
  return out


def _stage(jax_builder, port_builder):
  """(JAX scene, JAX config, port scene, port config, port arrays), the
  JAX tree by its numpy builder (the one the port copies)."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    jscene, jconfig = jax_builder().build()
  pb = port_builder()
  arrays, _ = pb.arrays()
  pscene, pconfig = pb.build(device="cpu")
  return jscene, jconfig, pscene, pconfig, arrays


def _renders(jscene, jconfig, pscene, pconfig):
  """(port image, JAX image, port rays, JAX rays) of iterations FIRST ..
  FIRST + SPP - 1."""
  sums, rays = jpt.render_samples_static(jscene, jconfig, FIRST, SPP, pool_size=POOL)
  fs = jpt.finalize_film(sums, SPP, jconfig.film_width)
  psums, prays = ppt.render_samples_static(pscene, pconfig, FIRST, SPP, pool_size=POOL,
                                           device="cpu")
  img = pfilm.result_image(ppt.finalize_film(psums, SPP, pconfig.film_width)).numpy()
  return img, np.asarray(fs.camera + fs.light), int(prays), float(rays)


def _check_tables(jscene, jconfig, arrays, config):
  want = _jax_arrays(jscene)
  for name in arrays:
    np.testing.assert_array_equal(np.asarray(arrays[name]), want[name], err_msg=name)
  for f in dataclasses.fields(ptypes.SceneConfig):
    assert getattr(config, f.name) == getattr(jconfig, f.name), f.name


def _check_render(img, ref, rays, ref_rays):
  assert img.shape == ref.shape == (FILM[1], FILM[0], 3)
  assert np.isfinite(img).all()
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.sum() <= OUTLIERS, outliers.sum()
  assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())
  assert rays == ref_rays


@pytest.fixture(scope="module")
def subset_a():
  def build(cornell, builder, types, spectrum, sdata):
    return lambda: shading_showcase.showcase(cornell, builder, types, spectrum, sdata,
                                             film_size=FILM, spheres=SUBSET, order=1)
  staged = _stage(build(jcornell, jbuilder, jtypes, jspectrum, jsdata),
                  build(pcornell, pbuilder, ptypes, pspectrum, psdata))
  return staged, _renders(*staged[:4])


def test_subset_a_tables_equal_jax(subset_a):
  (jscene, jconfig, pscene, pconfig, arrays), _ = subset_a
  _check_tables(jscene, jconfig, arrays, pconfig)
  assert pconfig.material_classes == (0, 3, 9, 10)
  assert not pconfig.has_alpha and pconfig.diffuse_variations == (0,)
  assert pscene.material_features == ("roughness_img", "metalness_img", "normal_img")


def test_subset_a_render_matches_jax_pixel_by_pixel(subset_a):
  _, (img, ref, rays, ref_rays) = subset_a
  _check_render(img, ref, rays, ref_rays)
  y = img @ pspectrum.RGB_TO_XYZ[1].astype(np.float64)
  assert y.min() >= -1e-5 * max(1.0, img.max())
