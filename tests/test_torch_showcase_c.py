"""Showcase subset C and the specular-box Cornell, by the port and by the
JAX package (CPU).

Subset C of the all-classes showcase (`tests/shading_showcase.py`; A and
B are test_torch_showcase_a.py's and _b.py's): the Plastic under its
checkered scattering image, the Mirror and the alpha-cut Diffuse (opacity
0.7 times a cut-out image alpha: the stochastic alpha test), in the
spectral Cornell box with its conductor tall box and a white-LED light, at
icosphere order 1. The specular-box Cornell (a smooth glass tall box, a
mirror short box, 36 triangles: the brute-force plain versions on the
port's side) renders in RGB. Both are staged by each package's builder
(tables equal) and rendered from iteration 1 for 4 iterations at 16x16,
held pixel by pixel by the tests' outlier threshold (test_torch_showcase_a).
"""

import numpy as np
import pytest
import torch

from etx_tracer_tpu.core import spectrum as jspectrum
from etx_tracer_tpu.scene import builder as jbuilder
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.scene import spectral_data as jsdata
from etx_tracer_tpu.scene import types as jtypes
from etx_tracer_tpu_torch.core import spectrum as pspectrum
from etx_tracer_tpu_torch.scene import builder as pbuilder
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.scene import spectral_data as psdata
from etx_tracer_tpu_torch.scene import types as ptypes
from tests import shading_showcase
from tests.test_torch_showcase_a import FILM, _check_render, _check_tables, _renders, _stage
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

SUBSET = ("plastic", "mirror", "alpha")


@pytest.fixture(scope="module")
def subset_c():
  def build(cornell, builder, types, spectrum, sdata):
    return lambda: shading_showcase.showcase(cornell, builder, types, spectrum, sdata,
                                             film_size=FILM, spheres=SUBSET, order=1)
  staged = _stage(build(jcornell, jbuilder, jtypes, jspectrum, jsdata),
                  build(pcornell, pbuilder, ptypes, pspectrum, psdata))
  return staged, _renders(*staged[:4])


@pytest.fixture(scope="module")
def specular_cornell():
  def build(cornell):
    return lambda: cornell.build_cornell_box(film_size=FILM, max_path_length=8,
                                             specular_boxes=True)
  staged = _stage(build(jcornell), build(pcornell))
  return staged, _renders(*staged[:4])


def test_subset_c_tables_equal_jax(subset_c):
  (jscene, jconfig, pscene, pconfig, arrays), _ = subset_c
  _check_tables(jscene, jconfig, arrays, pconfig)
  assert pconfig.material_classes == (0, 2, 3, 6)
  assert pconfig.has_alpha and pconfig.diffuse_variations == (0,)
  assert pscene.material_features == ("scattering_img",)


def test_subset_c_render_matches_jax_pixel_by_pixel(subset_c):
  _, (img, ref, rays, ref_rays) = subset_c
  _check_render(img, ref, rays, ref_rays)
  y = img @ pspectrum.RGB_TO_XYZ[1].astype(np.float64)
  assert y.min() >= -1e-5 * max(1.0, img.max())


def test_specular_cornell_tables_equal_jax(specular_cornell):
  (jscene, jconfig, _, pconfig, arrays), _ = specular_cornell
  _check_tables(jscene, jconfig, arrays, pconfig)
  assert pconfig.material_classes == (0, 4, 6) and arrays["tri_v0"].shape == (36, 3)


def test_specular_cornell_render_matches_jax_pixel_by_pixel(specular_cornell):
  _, (img, ref, rays, ref_rays) = specular_cornell
  _check_render(img, ref, rays, ref_rays)
  assert (img >= 0.0).all()
  third = FILM[0] // 3
  left, right = img[:, :third].mean((0, 1)), img[:, -third:].mean((0, 1))
  assert left[0] > left[1] and right[1] > right[0]
