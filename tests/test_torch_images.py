"""The port's image bank, distant emitters and cameras against the JAX
package (CPU).

The modules: the alias tables (against the JAX package's native builder,
which it uses whenever its library loads), the image bank, bilinear
lookups, alias draws and the sampling pdf, NEE toward and light paths from
all three emitter classes (the Cornell box's area light under the sun and
a small sky), the environment a missed ray gathers, and the thin-lens,
lens-image and equirectangular cameras. Then whole path-traced renders:
the environment-lit floor of the JAX package's image tests, a Cornell box
through a lens shaped by an image, an equirectangular Cornell box, and the
Cornell box without its light under an environment map.

Both packages get the same inputs, made from numpy seeds. Scene tables,
alias tables and image banks must be bit-equal. Functions are held within
MODULE_RTOL relative (MODULE_ATOL absolute near zero): XLA's and PyTorch's
atan2, asin, sin and cos may round apart, which moves an environment
lookup by ulps. Renders are held to the JAX package's jitted render pixel
by pixel, at tests/test_torch_render.py's tolerances; the Cornell renders
start at iteration FIRST (see tests/test_torch_media.py: iteration 0's
pixel-centre rays aim at the room's corner edges).
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.render import camera as jcamera
from etx_tracer_tpu.render import emitters as jemitters
from etx_tracer_tpu.render import images as jimages
from etx_tracer_tpu.scene import atmosphere as jatm
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.scene import types as jtypes
from etx_tracer_tpu.scene.builder import EmitterProfileDesc as JProfile
from etx_tracer_tpu.scene.builder import MaterialDesc as JMaterialDesc
from etx_tracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from etx_tracer_tpu_torch import scene_bridge
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.render import camera as pcamera
from etx_tracer_tpu_torch.render import emitters as pemitters
from etx_tracer_tpu_torch.render import images as pimages
from etx_tracer_tpu_torch.scene import atmosphere as patm
from etx_tracer_tpu_torch.scene import builder as pbuilder
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.scene import types as ptypes
from tests.test_torch_render import _jax_arrays
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FILM, SPP, MPL = (16, 16), 4, 4    # the whole-render comparisons
FIRST = 1                          # the Cornell renders' first iteration
SKY = (32, 16)                     # the small sky of the three-class scene
MODULE_RTOL = 1e-6                 # images.evaluate / sample / pdf_at, cameras
MODULE_ATOL = 1e-6
EMITTER_RTOL = 1e-5                # emitter functions (transcendentals chained)
EMITTER_ATOL = 1e-5
OUTLIER_FRACTION = 0.02            # whole render: pixels off by > 1e-4 + 1e-3 |ref|
MEAN_RTOL = 0.005                  # whole render: image mean
LANES = 4096


def _t(x):
  return torch.from_numpy(np.array(x))


def _close(got, want, what, rtol=MODULE_RTOL, atol=MODULE_ATOL):
  np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                             rtol=rtol, atol=atol, err_msg=what)


def load_native():
  """Assert that the JAX package's native library loads: its bank's alias
  tables are built by it (the Python fallback gives other tables, which
  the port does not copy). A checkout without the library builds it with
  g++ at first use, and another test process may be writing it: a failed
  load is retried for up to a minute."""
  lib = jnative.load()
  for _ in range(30):
    if lib is not None:
      break
    time.sleep(2.0)
    jnative._build_failed = False
    lib = jnative.load()
  assert lib is not None, "the JAX package's native library did not load"


@pytest.fixture(scope="module", autouse=True)
def native_builder():
  load_native()


# ------------------------------------------------------------ alias tables


@pytest.mark.parametrize("kind", ["random", "zero row", "sparse", "one hot"])
def test_alias_tables_equal_native(kind):
  rng = np.random.default_rng(3)
  if kind == "random":
    p = rng.random((4, 256)).astype(np.float32)
  elif kind == "zero row":
    p = rng.random((4, 256)).astype(np.float32)
    p[1] = 0.0
  elif kind == "sparse":
    p = (rng.random((64, 97)) ** 8).astype(np.float32)
    p[p < 0.1] = 0.0
  else:
    p = np.zeros((3, 33), np.float32)
    p[np.arange(3), [0, 16, 32]] = 1.0
  got = pimages.alias_tables(p)
  want = jnative.build_alias_tables(p)
  np.testing.assert_array_equal(got[0], want[0])
  np.testing.assert_array_equal(got[1], want[1])


def _images():
  rng = np.random.default_rng(4)
  sky = jatm.generate_sky_image(jatm.Parameters(), SKY, (0.3, 0.6, 0.5),
                                jatm.build_optical_length_lut(32))
  return [{"pixels": sky, "build_cdf": True},
          {"pixels": rng.random((20, 40, 4)).astype(np.float32), "build_cdf": False},
          {"pixels": rng.random((7, 9, 4)).astype(np.float32), "build_cdf": True,
           "uniform": True, "offset": (0.2, 0.0), "u_scale": -1.0},
          {"pixels": np.zeros((5, 6, 4), np.float32), "build_cdf": True}]


def test_bank_equals_jax():
  images = _images()
  got = pimages.build_bank(images)
  want = jimages.build_bank(images)
  assert set(got) == set(ptypes.ImageBank._fields)
  for name, v in got.items():
    w = np.asarray(getattr(want, name))
    assert v.dtype == w.dtype, name
    np.testing.assert_array_equal(v, w, err_msg=name)
  empty = pimages.build_bank([])
  assert pimages.bank_is_empty(ptypes.ImageBank(**{k: _t(v) for k, v in empty.items()}))


def _banks():
  images = _images()
  want = jimages.build_bank(images)
  got = ptypes.ImageBank(**{k: _t(v) for k, v in pimages.build_bank(images).items()})
  return got, want


def test_image_lookups_match_jax():
  """evaluate (uv outside [0, 1] too: repeat addressing), sample and
  pdf_at on every image with a distribution."""
  got_bank, want_bank = _banks()
  rng = np.random.default_rng(5)
  idx = rng.integers(0, 4, LANES).astype(np.int32)
  uv = rng.uniform(-1.5, 2.5, (LANES, 2)).astype(np.float32)
  _close(pimages.evaluate(got_bank, _t(idx).long(), _t(uv)),
         jimages.evaluate(want_bank, jnp.asarray(idx), jnp.asarray(uv)), "evaluate")
  uv01 = rng.uniform(0.0, 1.0, (LANES, 2)).astype(np.float32)
  _close(pimages.pdf_at(got_bank, _t(idx).long(), _t(uv01)),
         jimages.pdf_at(want_bank, jnp.asarray(idx), jnp.asarray(uv01)), "pdf_at")
  rnd = rng.uniform(0.0, 1.0, (LANES, 2)).astype(np.float32)
  rnd[:4] = [[0.0, 0.0], [1.0, 1.0], [1.0 - 2 ** -24, 0.5], [0.5, 1.0 - 2 ** -24]]
  sidx = rng.choice([0, 2], LANES).astype(np.int32)
  got_uv, got_pdf = pimages.sample(got_bank, _t(sidx).long(), _t(rnd))
  want_uv, want_pdf = jimages.sample(want_bank, jnp.asarray(sidx), jnp.asarray(rnd))
  _close(got_uv, want_uv, "sample uv")
  _close(got_pdf, want_pdf, "sample pdf")
  # every draw lands inside its image, on a texel of non-zero weight
  assert (got_uv.numpy() >= 0.0).all() and (got_uv.numpy() <= 1.0).all()
  assert (got_pdf.numpy()[sidx == 0] > 0.0).all()


# ------------------------------------------------------- emitters, cameras


@pytest.fixture(scope="module")
def lit():
  """{spectral: ((JAX scene, config), (port scene, config))}: the 16x16
  diffuse Cornell box with its light under the atmosphere's sun and a
  small sky, all three emitter classes."""
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    for spectral in (False, True):
      kw = dict(film_size=FILM, diffuse_only=True, max_path_length=MPL, spectral=spectral)
      jb, pb = jcornell.build_cornell_box(**kw), pcornell.build_cornell_box(**kw)
      jatm.add_atmosphere(jb, direction=(0.3, 0.6, 0.5), sky_size=SKY)
      patm.add_atmosphere(pb, direction=(0.3, 0.6, 0.5), sky_size=SKY)
      out[spectral] = (jb.build(), pb.build(device="cpu"))
  return out


def test_three_class_tables_equal_jax(lit):
  (jscene, jconfig), (pscene, pconfig) = lit[True]
  assert pconfig.emitter_classes == (0, 1, 2) and pconfig.num_env_emitters == 2
  want = _jax_arrays(jscene)
  for name in ("em_table", "prof_table", "emitters.pdf", "emitters.cdf",
               "emitters.total_weight", "emitters.env_indices", "emitters.env_count",
               "camera.lens_image", "bsphere_radius"):
    got = pscene
    for part in name.split("."):
      got = getattr(got, part)
    np.testing.assert_array_equal(got.numpy(), want[name], err_msg=name)
  for name in ptypes.ImageBank._fields:
    np.testing.assert_array_equal(getattr(pscene.images, name).numpy(), want[f"images.{name}"],
                                  err_msg=name)
  for f in dataclasses.fields(ptypes.SceneConfig):
    assert getattr(pconfig, f.name) == getattr(jconfig, f.name), f.name


def _inputs(n, seed, spectral):
  rng = np.random.default_rng(seed)
  rnd = rng.uniform(size=(n, 2)).astype(np.float32)
  wl = (rng.uniform(380.0, 780.0, n) if spectral else np.zeros(n)).astype(np.float32)
  return rng, rnd, wl


@pytest.mark.parametrize("spectral", [False, True])
def test_sample_emitter_matches_jax(lit, spectral):
  (jscene, jconfig), (pscene, pconfig) = lit[spectral]
  rng, rnd, wl = _inputs(LANES, 6, spectral)
  n_em = pscene.em_table.shape[0]
  idx = rng.integers(0, n_em, LANES).astype(np.int32)
  pts = rng.uniform((-0.9, 0.1, -0.9), (0.9, 1.9, 0.9), (LANES, 3)).astype(np.float32)
  got = pemitters.sample_emitter(pscene, _t(idx).long(), _t(rnd), _t(pts), _t(wl), spectral,
                                 pconfig.emitter_classes)
  want = jemitters.sample_emitter(jscene, jnp.asarray(idx), jnp.asarray(rnd), jnp.asarray(pts),
                                  jnp.asarray(wl), spectral, classes=jconfig.emitter_classes)
  np.testing.assert_array_equal(got.is_delta.numpy(), np.asarray(want.is_delta))
  np.testing.assert_array_equal(got.triangle_index.numpy(), np.asarray(want.triangle_index))
  for f in ("value", "origin", "normal", "direction", "pdf_sample", "pdf_area", "pdf_dir",
            "pdf_dir_out"):
    _close(getattr(got, f), getattr(want, f), f, EMITTER_RTOL, EMITTER_ATOL)
  cls = pscene.em_table[idx, 0].numpy()
  assert {0, 1, 2} <= set(cls.tolist())
  assert (got.pdf_dir.numpy()[cls != 0] > 0).all()


@pytest.mark.parametrize("spectral", [False, True])
def test_sample_emission_matches_jax(lit, spectral):
  (jscene, _), (pscene, _) = lit[spectral]
  rng, sel, wl = _inputs(LANES, 7, spectral)
  sel = sel[:, 0]
  pos, d = (rng.uniform(size=(LANES, 2)).astype(np.float32) for _ in range(2))
  got = pemitters.sample_emission(pscene, _t(sel), _t(pos), _t(d), _t(wl), spectral)
  want = jemitters.sample_emission(jscene, *(jnp.asarray(x) for x in (sel, pos, d, wl)),
                                   spectral)
  for f in ("is_delta", "is_distant", "triangle_index", "medium_index"):
    np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
  for f in ("value", "origin", "normal", "direction", "pdf_sample", "pdf_area", "pdf_dir",
            "pdf_dir_out", "geo_n"):
    _close(getattr(got, f), getattr(want, f), f, EMITTER_RTOL, EMITTER_ATOL)
  assert got.is_distant.numpy().mean() > 0.5 and got.is_delta.numpy().any()


@pytest.mark.parametrize("spectral", [False, True])
def test_env_contribution_matches_jax(lit, spectral):
  """Random directions, a tenth of them straight at the sun (visible
  directly or not), with random MIS flags and BSDF pdfs."""
  (jscene, jconfig), (pscene, pconfig) = lit[spectral]
  rng, _, wl = _inputs(LANES, 8, spectral)
  d = rng.normal(size=(LANES, 3)).astype(np.float32)
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  sun = np.asarray(jscene.emitter_profiles.direction)[1]
  d[::10] = sun
  direct = rng.uniform(size=LANES) < 0.5
  mis = rng.uniform(size=LANES) < 0.7
  pdf = rng.uniform(0.01, 3.0, LANES).astype(np.float32)
  got = pemitters.env_contribution(pscene, _t(d), _t(wl), _t(direct), _t(mis), _t(pdf),
                                   pconfig.num_env_emitters, spectral)
  want = jemitters.env_contribution(jscene, *(jnp.asarray(x) for x in (d, wl, direct, mis, pdf)),
                                    jconfig.num_env_emitters, spectral)
  _close(got, want, "env", EMITTER_RTOL, EMITTER_ATOL)
  assert (got.numpy() != 0).any(axis=-1).mean() > 0.9
  # the sun shows to the directly visible rays at it, and to no other ray
  sun_rgb = got.numpy()[::10][direct[::10]]
  assert (sun_rgb.max(axis=-1) > 10.0 * got.numpy()[1::10].max()).all()


def _dof_builders(film=FILM, **kw):
  """(JAX builder, port builder) of `cornell.build_dof_cornell_box`."""
  kw = dict(film_size=film, diffuse_only=True, max_path_length=MPL, **kw)
  jb, pb = jcornell.build_cornell_box(**kw), pcornell.build_dof_cornell_box(**kw)
  jb.lens_radius, jb.focal_distance = pb.lens_radius, pb.focal_distance
  jb.camera_lens_image = jb.add_image(pcornell.aperture_image(), build_cdf=True)
  return jb, pb


@pytest.mark.parametrize("mode", ["lens", "lens image", "equirectangular"])
def test_generate_ray_matches_jax(monkeypatch, mode):
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
  jb, pb = _dof_builders()
  if mode == "lens":
    jb.camera_lens_image = pb.camera_lens_image = -1
  for b in (jb, pb):
    b.camera_equirectangular = mode == "equirectangular"
  (jscene, jconfig), (pscene, pconfig) = jb.build(), pb.build(device="cpu")
  rng = np.random.default_rng(9)
  uv = rng.uniform(-1.0, 1.0, (LANES, 2)).astype(np.float32)
  rnd = rng.uniform(size=(LANES, 2)).astype(np.float32)
  lens = pcamera.lens_of(pscene.camera)
  assert lens == pcamera.Lens(True, -1 if mode == "lens" else 0)
  got = pcamera.generate_ray(pscene.camera, _t(uv), _t(rnd), lens, pscene.images,
                             pconfig.equirectangular)
  want = jcamera.generate_ray(jscene.camera, jnp.asarray(uv), jnp.asarray(rnd), scene=jscene,
                              equirectangular=jconfig.equirectangular)
  for g, w, name in zip(got, want, ("o", "d", "t_min", "t_max")):
    _close(g.expand(w.shape), w, name)
  spread = got.o.numpy().std(axis=0)
  assert (spread > 1e-3).any() == (mode != "equirectangular")


# ------------------------------------------------------------ whole renders


def _env_floor_jax(film, spectral=False):
  """`atmosphere.env_floor_scene`, staged with the JAX builder."""
  b = JSceneBuilder()
  b.film_size = film
  b.max_path_length = 3
  b.spectral = spectral
  white = b.add_rgb_reflectance([0.8, 0.8, 0.8])
  m = b.add_material(JMaterialDesc(cls=jtypes.MaterialClass.Diffuse, scattering_spec=white,
                                   two_sided=True))
  b.add_mesh(np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32),
             np.array([[0, 1, 2], [0, 2, 3]], np.int32), m)
  b.add_distant_emitter(JProfile(cls=jtypes.EmitterClass.Environment, emission_spec=1,
                                 emission_img=b.add_image(_env_map(), build_cdf=True)))
  b.set_camera(origin=(0, 1.0, 3), target=(0, 0.5, 0), up=(0, 1, 0), fov=60, film_size=film)
  return b


def _env_map():
  env = np.zeros((8, 16, 4), np.float32)
  env[:4] = [2.0, 1.0, 0.5, 1.0]
  return env


def render_builders(name, film=FILM):
  """(JAX builder, port builder, first iteration) of a render of this
  slice."""
  kw = dict(film_size=film, diffuse_only=True, max_path_length=MPL)
  if name == "env floor":
    return _env_floor_jax(film), patm.env_floor_scene(film), 0
  if name == "dof cornell":
    return (*_dof_builders(film), FIRST)
  if name == "equirectangular cornell":
    jb, pb = jcornell.build_cornell_box(**kw), pcornell.build_cornell_box(**kw)
    for b in (jb, pb):
      # inside the room, which then fills the panorama
      b.set_camera(origin=(0.0, 1.0, 0.5), target=(0.0, 1.0, -1.0), up=(0.0, 1.0, 0.0),
                   fov=90.0, film_size=film, clip_near=0.1, clip_far=100.0)
      b.camera_equirectangular = True
    return jb, pb, FIRST
  jb = jcornell.build_cornell_box(with_light=False, **kw)
  pb = pcornell.build_cornell_box(with_light=False, **kw)
  jb.add_distant_emitter(JProfile(cls=jtypes.EmitterClass.Environment, emission_spec=1,
                                  emission_img=jb.add_image(_env_map(), build_cdf=True)))
  pb.add_distant_emitter(patm.EmitterProfileDesc(
      cls=ptypes.EmitterClass.Environment, emission_spec=1,
      emission_img=pb.add_image(_env_map(), build_cdf=True)))
  return jb, pb, FIRST


_RENDERS = ["env floor", "dof cornell", "equirectangular cornell", "unlit cornell under an env"]


@pytest.mark.parametrize("name", _RENDERS)
def test_render_matches_jax_pixel_by_pixel(monkeypatch, name):
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
  jb, pb, first = render_builders(name)
  (jscene, jconfig), (pscene, pconfig) = jb.build(), pb.build(device="cpu")
  want = _jax_arrays(jscene)
  for key, v in pb.arrays()[0].items():
    if not key.startswith("bvh."):
      np.testing.assert_array_equal(np.asarray(v), want[key], err_msg=key)
  pool = FILM[0] * FILM[1] * SPP
  sums, rays = jpt.render_samples_static(jscene, jconfig, first, SPP, pool_size=pool)
  ref = np.asarray(jpt.finalize_film(sums, SPP, FILM[0]).camera)
  psums, prays = ppt.render_samples_static(pscene, pconfig, first, SPP, pool_size=pool,
                                           device="cpu")
  img = ppt.finalize_film(psums, SPP, FILM[0]).camera.numpy()
  assert np.isfinite(img).all() and (img >= 0.0).all() and img.mean() > 0.01
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.mean() <= OUTLIER_FRACTION, outliers.mean()
  assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())
  assert int(prays) == pytest.approx(float(rays), rel=0.005)


def test_scene_bridge_carries_the_bank_lens_and_distant_emitters(monkeypatch):
  """The JAX tables of the DOF Cornell box under the sun and a small sky,
  carried across as numpy, give the builder's scene: its bank (the JAX
  bank's CDF stand-ins dropped), lens image, distant emitters and
  configuration."""
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
  jb, pb = _dof_builders()
  jatm.add_atmosphere(jb, direction=(0.3, 0.6, 0.5), sky_size=SKY)
  patm.add_atmosphere(pb, direction=(0.3, 0.6, 0.5), sky_size=SKY)
  jscene, jconfig = jb.build()
  scene, config = scene_bridge.from_numpy(_jax_arrays(jscene), dataclasses.asdict(jconfig),
                                          device="cpu")
  want, want_config = pb.build(device="cpu")
  assert config == want_config and config.emitter_classes == (0, 1, 2)
  for f in ptypes.DeviceScene._fields:
    if f in ("bvh", "spec_at_wl"):
      continue
    got_t, want_t = getattr(scene, f), getattr(want, f)
    for g, w in zip(got_t if isinstance(got_t, tuple) else [got_t],
                    want_t if isinstance(want_t, tuple) else [want_t]):
      assert torch.equal(g, w), f
  assert int(scene.camera.lens_image) == 0 and scene.images.pixels.shape[0] == 3


def test_material_textures_still_raise(monkeypatch):
  """The builder and the scene bridge take a material with an image (the
  shading slice brought texturing; they refused it before): the same
  tables as the JAX package's, and the bridge carries the texture fact
  across."""
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
  pb = pcornell.build_cornell_box(film_size=FILM, diffuse_only=True)
  pb.materials[0] = dataclasses.replace(pb.materials[0],
                                        scattering_img=pb.add_image(np.ones((4, 4, 4), np.float32)))
  jb = jcornell.build_cornell_box(film_size=FILM, diffuse_only=True)
  jb.materials[0] = dataclasses.replace(jb.materials[0],
                                        scattering_img=jb.add_image(np.ones((4, 4, 4), np.float32)))
  jscene, jconfig = jb.build()
  arrays, config = pb.arrays()
  want = _jax_arrays(jscene)
  for name in arrays:
    np.testing.assert_array_equal(np.asarray(arrays[name]), want[name], err_msg=name)
  scene, bconfig = scene_bridge.from_numpy(want, dataclasses.asdict(jconfig), device="cpu")
  assert bconfig == config and scene.material_features == ("scattering_img",)
