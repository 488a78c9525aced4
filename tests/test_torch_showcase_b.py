"""Showcase subset B by the port and by the JAX package (CPU): path
tracing with blue noise.

Subset B of the all-classes showcase (`tests/shading_showcase.py`; A and
C are test_torch_showcase_a.py's and _c.py's): the Velvet, the
Translucent and the two rough-diffuse variations (1, the Heitz walk; 2,
the vMF fit), in the spectral Cornell box with its conductor tall box and
a white-LED light, at icosphere order 1. It renders by path tracing with
`blue_noise` (the first bounce's BSDF and emitter draws from the rotated
R2 points) from iteration 1 for 4 iterations at 16x16, held pixel by pixel
by the tests' outlier threshold (test_torch_showcase_a); its VCM render is
test_torch_showcase_d.py's.

The walk's microfacet normal goes through acos, atan2, sin and cos, which
XLA and PyTorch round apart by an ulp on some lanes; the walk's escape and
scattering tests then send such a lane elsewhere (traced on one lane of
4,096: `sample_microfacet_normal`'s first call differs in the last bit,
everything before it is equal). Its sample carries another weight, and
its pixel another value: WALK_OUTLIERS pixels may be outliers, the image
mean agrees within WALK_MEAN_RTOL and the rays within WALK_RAYS_RTOL.
Without the walk the renders agree in every pixel
(test_torch_showcase_d.py holds that too).
"""

import dataclasses

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
from tests.test_torch_showcase_a import FILM, _check_tables, _renders, _stage
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

SUBSET = ("velvet", "translucent", "diffuse_v1", "diffuse_v2")
WALK_OUTLIERS = 16      # of 256 pixels (7 measured): the walk's parted lanes
WALK_MEAN_RTOL = 0.005  # image means
WALK_RAYS_RTOL = 0.01   # rays traced


@pytest.fixture(scope="module")
def subset_b():
  def build(cornell, builder, types, spectrum, sdata):
    return lambda: shading_showcase.showcase(cornell, builder, types, spectrum, sdata,
                                             film_size=FILM, spheres=SUBSET, order=1)
  return _stage(build(jcornell, jbuilder, jtypes, jspectrum, jsdata),
                build(pcornell, pbuilder, ptypes, pspectrum, psdata))


def test_subset_b_tables_equal_jax(subset_b):
  jscene, jconfig, pscene, pconfig, arrays = subset_b
  _check_tables(jscene, jconfig, arrays, pconfig)
  assert pconfig.material_classes == (0, 1, 3, 8)
  assert pconfig.diffuse_variations == (0, 1, 2) and not pconfig.has_alpha
  assert pscene.material_features == ()


def test_subset_b_blue_noise_render_matches_jax_pixel_by_pixel(subset_b):
  jscene, jconfig, pscene, pconfig, _ = subset_b
  jconfig = dataclasses.replace(jconfig, blue_noise=True)
  pconfig = dataclasses.replace(pconfig, blue_noise=True)
  img, ref, rays, ref_rays = _renders(jscene, jconfig, pscene, pconfig)
  check_walk_render(img, ref, rays, ref_rays)


def check_walk_render(img, ref, rays, ref_rays, outliers=WALK_OUTLIERS):
  """The pixels of a render with the diffuse walk (see the docstring): at
  most `outliers` outlier pixels."""
  assert img.shape == ref.shape and np.isfinite(img).all()
  off = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  print(f"walk render: {int(off.sum())} outlier pixels, means {img.mean()!r} / "
        f"{ref.mean()!r}, rays {rays} / {ref_rays}")
  assert off.sum() <= outliers, off.sum()
  assert abs(img.mean() - ref.mean()) <= WALK_MEAN_RTOL * abs(ref.mean())
  assert rays == pytest.approx(ref_rays, rel=WALK_RAYS_RTOL)
