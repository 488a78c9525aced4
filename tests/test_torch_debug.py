"""The port's debug AOVs and denoiser against the JAX package (CPU).

Each of the 18 debug modes is one JAX compile (`render_debug`'s mode is a
static argument) and one case of a parametrised test. The geometric modes
render the Cornell scene files at 20x20 (the configuration `cli render
--size 20x20 --max-path 4 --spp 2` gives them; at 16x16 no pixel centre
sees the light); the modes that read
material data (texture coordinates, albedo, Fresnel, the transmittance and
reflectance colours, the IOR) render a spectral subset of the shading
showcase (tests/shading_showcase.py: a checkered plastic, a principled
sphere with roughness, metalness and normal-map images, an alpha-tested
diffuse and a mirror given a thin film). The two plots trace nothing. Both
packages start from bit-identical tables; an image is held within
AOV_RTOL/AOV_ATOL on at least 98% of its pixels (a camera ray that grazes
a room's edge through a pixel centre may hit the neighbouring face, or
miss, in the other package: 3 of 400 pixels here).

The denoiser's four functions run on a seeded noisy film (colour with
fireflies, normals, albedo, the half buffer) and must agree within
DENOISE_RTOL: their exp and sqrt round apart by ulps between XLA and
PyTorch.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu_torch import native as pnative
from etx_tracer_tpu.core import spectrum as jspectrum
from etx_tracer_tpu.models import debug as jdebug
from etx_tracer_tpu.render import denoiser as jden
from etx_tracer_tpu.render import film as jfilm
from etx_tracer_tpu.scene import builder as jbuilder
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.scene import json_scene as jjson
from etx_tracer_tpu.scene import spectral_data as jsdata
from etx_tracer_tpu.scene import types as jtypes
from etx_tracer_tpu_torch import scene_bridge
from etx_tracer_tpu_torch.core import spectrum as pspectrum
from etx_tracer_tpu_torch.models import debug as pdebug
from etx_tracer_tpu_torch.render import denoiser as pden
from etx_tracer_tpu_torch.scene import assets as passets
from etx_tracer_tpu_torch.scene import builder as pbuilder
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.scene import json_scene as pjson
from etx_tracer_tpu_torch.scene import spectral_data as psdata
from etx_tracer_tpu_torch.scene import types as ptypes
from tests import shading_showcase
from tests.test_torch_images import load_native
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FILM = (16, 16)            # the showcase
CORNELL_FILM = (20, 20)    # the Cornell scene files
AOV_RTOL, AOV_ATOL = 1e-5, 1e-5
PIXEL_FRACTION = 0.02      # pixels an AOV may differ on (edge-grazing rays)
DENOISE_RTOL, DENOISE_ATOL = 2e-5, 1e-6

M = pdebug.DebugMode
MATERIAL_MODES = (M.TexCoords, M.Albedo, M.Fresnel, M.TransmittanceColor,
                  M.ReflectanceColor, M.IOR)


@pytest.fixture(scope="module")
def cornell_files(tmp_path_factory):
  """((JAX scene, config), (port scene, config)) of the Cornell scene files
  as the CLI sizes them."""
  path = passets.write_cornell_asset(str(tmp_path_factory.mktemp("cornell")))
  out = []
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "parse_obj_native", lambda *a, **k: None)
    mp.setattr(pnative, "parse_obj_native", lambda *a, **k: None)
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    for load in (jjson.load_scene, pjson.load_scene):
      b = load(path)
      b.film_size, b.samples, b.max_path_length = CORNELL_FILM, 2, 4
      out.append(b)
    return out[0].build(), out[1].build(device="cpu")


def _showcase(cornell, builder, types, spectrum, sdata):
  b = shading_showcase.showcase(cornell, builder, types, spectrum, sdata, film_size=FILM,
                                spheres=("plastic", "principled", "mirror", "alpha"), order=1)
  film = b.add_spectrum(spectrum.SpectralDistribution.constant(
      1.33, spectrum.SpectralDistribution.CLASS_DIELECTRIC))
  i = b.material_names["mirror"]
  b.materials[i] = dataclasses.replace(b.materials[i], thinfilm_eta=film, thinfilm_min=250.0,
                                       thinfilm_max=450.0)
  return b


@pytest.fixture(scope="module")
def showcase_scenes():
  load_native()
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    jax = _showcase(jcornell, jbuilder, jtypes, jspectrum, jsdata).build()
  port = _showcase(pcornell, pbuilder, ptypes, pspectrum, psdata).build(device="cpu")
  assert "thinfilm" in port[0].material_features and port[1].spectral
  return jax, port


def _assert_aov(got, want, mode, film):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape == (film[1], film[0], 3) and np.isfinite(got).all()
  off = (np.abs(got - want) > AOV_ATOL + AOV_RTOL * np.abs(want)).any(axis=-1)
  assert off.mean() <= PIXEL_FRACTION, f"mode {mode}: {int(off.sum())} pixels differ"


@pytest.mark.parametrize("mode", range(M.Count))
def test_debug_mode_matches_jax(mode, request):
  scenes = request.getfixturevalue("showcase_scenes" if mode in MATERIAL_MODES
                                   else "cornell_files")
  (js, jc), (ps, pc) = scenes
  want = jdebug.render_debug(js, jc, mode)
  got = pdebug.render_debug(ps, pc, mode, device="cpu")
  _assert_aov(got.numpy(), want, mode, (pc.film_width, pc.film_height))
  assert float(got.abs().sum()) > 0.0  # every mode shows something here
  if mode == M.Random:
    assert float(got.std()) > 0.2


def _noisy_film(seed=4, h=20, w=24):
  rs = np.random.default_rng(seed)
  base = np.linspace(0.05, 0.6, w, dtype=np.float32)[None, :, None] * np.ones((h, 1, 3), np.float32)
  base[:, w // 2:] *= np.float32([1.0, 0.4, 0.2])
  cam = base * (1.0 + 0.3 * rs.standard_normal((h, w, 3)).astype(np.float32))
  cam[3, 5] = 40.0  # fireflies, one on the wrapped edge
  cam[0, w - 1] = 25.0
  half = cam * (1.0 + 0.2 * rs.standard_normal((h, w, 3)).astype(np.float32))
  nrm = np.zeros((h, w, 3), np.float32)
  nrm[:, : w // 2, 2] = 1.0
  nrm[:, w // 2:, 0] = 1.0
  alb = np.clip(base * 1.5, 0.0, 1.0)
  z = np.zeros((h, w, 3), np.float32)
  return dict(camera=cam, variance_half=half, normals=nrm, albedo=alb, light=z,
              light_iteration=z, iteration=np.int32(8))


def _close(got, want, what):
  np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                             rtol=DENOISE_RTOL, atol=DENOISE_ATOL, err_msg=what)


@pytest.mark.parametrize("iterations", [None, 2])
def test_denoiser_matches_jax(iterations):
  layers = _noisy_film()
  jfs = jfilm.FilmState(**{k: jnp.asarray(v) for k, v in layers.items()})
  pfs = scene_bridge.film_state_from_numpy(layers, "cpu")
  var = pden.film_variance(pfs)
  _close(var, jden.film_variance(jfs), "film_variance")
  clamped = pden.firefly_clamp(pfs.camera)
  _close(clamped, jden.firefly_clamp(jfs.camera), "firefly_clamp")
  assert float(clamped[3, 5, 0]) < 40.0 and float(clamped[0, -1, 0]) < 25.0
  n = 3 if iterations is None else iterations
  for variance in (None, var):
    got = pden.denoise(pfs.camera, pfs.normals, pfs.albedo, variance=variance, iterations=n)
    want = jden.denoise(jfs.camera, jfs.normals, jfs.albedo,
                        variance=None if variance is None else jnp.asarray(variance.numpy()),
                        iterations=n)
    _close(got, want, f"denoise (variance: {variance is not None})")
  got = pden.denoise_film(pfs, iterations=iterations)
  _close(got, jden.denoise_film(jfs, iterations=iterations), "denoise_film")
  assert got.shape == (20, 24, 3)


def test_firefly_clamp_wraps_around_the_edges():
  """The 8-neighbourhood wraps around (torch.roll, as the JAX jnp.roll):
  a hot pixel in a corner is replaced by the mean of neighbours taken from
  the opposite edges."""
  img = np.full((6, 7, 3), 0.1, np.float32)
  img[:, -1] = 0.9  # the far column: the corner's wrapped neighbours
  img[0, 0] = 50.0
  got = pden.firefly_clamp(torch.from_numpy(img)).numpy()
  want = np.asarray(jden.firefly_clamp(jnp.asarray(img)))
  np.testing.assert_array_equal(got, want)
  expect = (3 * 0.9 + 5 * 0.1) / 8.0
  assert abs(got[0, 0, 0] - expect) < 1e-6
