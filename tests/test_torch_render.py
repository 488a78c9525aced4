"""The port's scene, render modules and main path against the JAX package (CPU).

Both packages get the same inputs, made from numpy seeds. Scene tables are
built by the same numpy code on both sides and must be equal. Module
outputs agree to a few float32 ulps (1e-5): the JAX side runs eagerly here,
one XLA operation at a time, and differs only in its transcendental
functions. The whole render is held against the JAX package's jitted render
(whose XLA fuses multiply-adds, so single samples may take another branch at
a triangle edge or a roulette threshold) pixel by pixel: at most 2% of the
pixels may differ by more than 1e-4 + 1e-3 |ref|, the image means agree
within 0.5%, and the port matches the JAX package's golden values at
tests/test_golden.py's own tolerances. The JAX render is built once for the
module, with test_golden.py's exact configuration so that its compiled
executable is shared through the persistent compile cache.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.ops import gather as jgather
from etx_tracer_tpu.render import camera as jcamera
from etx_tracer_tpu.render import emitters as jemitters
from etx_tracer_tpu.render.bsdf import dispatch as jdispatch
from etx_tracer_tpu.render.bsdf import lobes as jlobes
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.scene import packed as jpacked
from etx_tracer_tpu_torch import default_device
from etx_tracer_tpu_torch import scene_bridge
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.render import camera as pcamera
from etx_tracer_tpu_torch.render import emitters as pemitters
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.render.bsdf import dispatch as pdispatch
from etx_tracer_tpu_torch.render.bsdf import lobes as plobes
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.scene import packed as ppacked
from etx_tracer_tpu_torch.scene import types as ptypes
from tests.test_golden import GOLDEN_MEAN, GOLDEN_PROBES, GOLDEN_TOTAL
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FILM, MPL, SPP = (32, 32), 6, 4   # test_golden.py's configuration
MODULE_ATOL = 1e-5                # eager JAX vs the port, per module
OUTLIER_FRACTION = 0.02           # whole render: pixels off by > 1e-4 + 1e-3 |ref|
MEAN_RTOL = 0.005                 # whole render: image mean


def _jax_arrays(scene):
  """The JAX DeviceScene's leaves as numpy arrays keyed by dotted field path
  (the per-step cache aside; the BVH's fat rows only when the tree has them;
  the image bank's fields with them, the port reading those it needs)."""
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


def _numpy_tree(monkeypatch):
  """Turn the JAX package's native BVH builder off: it builds its trees with
  the numpy builder the port copies, so both packages freeze the same BVH."""
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)


@pytest.fixture(scope="module")
def jax_scene():
  with pytest.MonkeyPatch.context() as mp:
    _numpy_tree(mp)
    return jcornell.build_cornell_box(film_size=FILM, diffuse_only=True,
                                      max_path_length=MPL).build()


@pytest.fixture(scope="module")
def jax_golden(jax_scene):
  """The JAX package's golden render: (image, FilmSums table, rays traced)."""
  scene, config = jax_scene
  sums, rays = jpt.render_samples_static(scene, config, 0, SPP,
                                         pool_size=min(1 << 17, FILM[0] * FILM[1] * SPP))
  fs = jpt.finalize_film(sums, SPP, config.film_width)
  return np.asarray(fs.camera + fs.light), np.asarray(sums.table), float(rays)


@pytest.fixture(scope="module")
def port_scene():
  return pcornell.build_cornell_box(film_size=FILM, diffuse_only=True,
                                    max_path_length=MPL).build(device="cpu")


@pytest.fixture(scope="module")
def port_golden(port_scene):
  scene, config = port_scene
  sums, rays = ppt.render_samples_static(scene, config, 0, SPP,
                                         pool_size=min(1 << 17, FILM[0] * FILM[1] * SPP),
                                         device="cpu")
  fs = ppt.finalize_film(sums, SPP, config.film_width)
  return pfilm.result_image(fs).numpy(), sums.table.numpy(), int(rays)


# ------------------------------------------------------------------- scene


def test_cornell_tables_equal_jax(jax_scene):
  arrays, config = pcornell.build_cornell_box(film_size=FILM, diffuse_only=True,
                                              max_path_length=MPL).arrays()
  want = _jax_arrays(jax_scene[0])
  assert set(arrays) <= set(want)
  for name in arrays:
    w = want[name]
    got = np.asarray(arrays[name])
    assert got.shape == w.shape, name
    np.testing.assert_array_equal(got, w.astype(got.dtype), err_msg=name)
    assert got.dtype == w.dtype, name
  jconfig = jax_scene[1]
  for f in dataclasses.fields(ptypes.SceneConfig):
    assert getattr(config, f.name) == getattr(jconfig, f.name), f.name
  assert arrays["tri_v0"].shape == (36, 3)
  assert (arrays["tri_table"][:, 4] >= 0).sum() == 2  # two emitter triangles


def test_scene_bridge_gives_the_builders_scene(jax_scene, port_scene):
  scene, config = scene_bridge.from_numpy(_jax_arrays(jax_scene[0]),
                                          dataclasses.asdict(jax_scene[1]), device="cpu")
  want, want_config = port_scene
  assert config == want_config
  tables = [f for f in ptypes.DeviceScene._fields if f != "spec_at_wl"]
  for got_t, want_t in zip((getattr(scene, f) for f in tables),
                           (getattr(want, f) for f in tables)):
    for g, w in zip(got_t if isinstance(got_t, tuple) else [got_t],
                    want_t if isinstance(want_t, tuple) else [want_t]):
      assert g.dtype == w.dtype and torch.equal(g, w)
  # the BVH kernels' tables hold the JAX tree, field by field
  assert_bvh_holds_tree(scene.bvh, _jax_arrays(jax_scene[0]))
  assert scene.bvh.node_table.shape == (25, 8) and scene.bvh.fat_table.shape == (12, 16)


def assert_bvh_holds_tree(bvh, arrays):
  """The device BVH's kernel tables hold the tree of the numpy scene arrays
  (the JAX layout): boxes as float32 bits, int32 ids and counts (a node's
  word 6: a leaf's first triangle row, an inner node's skip, as the JAX
  tree's `node_skip` gives it), the triangles in leaf order with their
  ids."""
  def f32(x):
    return x.contiguous().view(torch.float32).numpy()

  nodes = bvh.node_table
  count = arrays["bvh.node_count"]
  np.testing.assert_array_equal(f32(nodes[:, 0:3]), arrays["bvh.node_min"])
  np.testing.assert_array_equal(f32(nodes[:, 3:6]), arrays["bvh.node_max"])
  np.testing.assert_array_equal(
      nodes[:, 6].numpy(), np.where(count > 0, arrays["bvh.node_left"], arrays["bvh.node_skip"]))
  np.testing.assert_array_equal(nodes[:, 7].numpy(), count)
  fat = arrays.get("bvh.fat_rows")
  assert (bvh.fat_table is None) == (fat is None)
  if fat is not None:
    np.testing.assert_array_equal(f32(bvh.fat_table[:, :12]), fat[:, :12])
    np.testing.assert_array_equal(bvh.fat_table[:, 12:].numpy(), fat[:, 12:])
  prim = np.asarray(arrays["bvh.prim_index"])
  rows = bvh.prim_tris.numpy()
  for k, name in enumerate(("tri_v0", "tri_e1", "tri_e2")):
    np.testing.assert_array_equal(rows[:, 3 * k:3 * k + 3], arrays[name][prim])
  np.testing.assert_array_equal(rows[:, 9].view(np.int32), prim)
  assert not rows[:, 10:].any()


@pytest.mark.parametrize("field,value", [("spectral", True), ("material_classes", (0, 3, 4, 5)),
                                         ("has_media", True), ("has_radiance_clamp", True),
                                         ("material_classes", (0, 7)), ("blue_noise", True),
                                         ("material_classes", (0, 6)),
                                         ("material_classes", tuple(range(11))),
                                         ("diffuse_variations", (0, 1, 2)),
                                         ("has_alpha", True), ("validate", True)])
def test_scene_bridge_accepts_the_materials_options(jax_scene, field, value):
  """The options of the ported slices: spectral mode and the materials
  classes, media, the radiance clamp and the Boundary class; blue noise,
  every class, the diffuse variations and the alpha test; the validating
  build."""
  fields = dict(dataclasses.asdict(jax_scene[1]), **{field: value})
  _, config = scene_bridge.from_numpy(_jax_arrays(jax_scene[0]), fields, device="cpu")
  assert getattr(config, field) == value


@pytest.mark.parametrize("kwargs", [{"spectral": True, "diffuse_only": True},
                                    {"diffuse_only": False}, {"fog_grid": np.ones((2, 2, 2))},
                                    {"fog_scattering": 0.5}, {"with_light": False},
                                    {"specular_boxes": True},
                                    {"specular_boxes": True, "spectral": True}])
def test_cornell_options_of_the_materials_slice_build_as_in_jax(monkeypatch, kwargs):
  """The spectral Cornell box, the one with the conductor tall box, the
  ones filled with a heterogeneous or a homogeneous fog (the media slice),
  the one without its light (one Undefined emitter of weight 0, the
  environment slice) and the one with a glass and a mirror box (the
  shading slice) freeze the JAX package's tables."""
  _numpy_tree(monkeypatch)
  arrays, config = pcornell.build_cornell_box(film_size=FILM, max_path_length=MPL,
                                              **kwargs).arrays()
  jscene, jconfig = jcornell.build_cornell_box(film_size=FILM, max_path_length=MPL,
                                               **kwargs).build()
  want = _jax_arrays(jscene)
  for name in arrays:
    np.testing.assert_array_equal(np.asarray(arrays[name]), want[name], err_msg=name)
  for f in dataclasses.fields(ptypes.SceneConfig):
    assert getattr(config, f.name) == getattr(jconfig, f.name), f.name


# ----------------------------------------------------------------- modules


def test_camera_rays_match_jax(jax_scene, port_scene):
  rng = np.random.default_rng(0)
  uv = rng.uniform(-1.0, 1.0, (4096, 2)).astype(np.float32)
  want = jcamera.generate_ray(jax_scene[0].camera, jnp.asarray(uv), jnp.zeros((4096, 2)))
  got = pcamera.generate_ray(port_scene[0].camera, torch.from_numpy(uv))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=MODULE_ATOL)


def test_pixel_jitter_matches_jax():
  rng = np.random.default_rng(1)
  rnd = rng.uniform(size=(4096, 2)).astype(np.float32)
  rnd[:4, 1] = [0.0, 0.9, 0.9000001, 1.0 - 2 ** -24]
  it = rng.integers(0, 3, 4096)
  for filt in ("blackman-harris", "box", "center"):
    want = jcamera.pixel_jitter(filt, jnp.asarray(rnd), jnp.asarray(it.astype(np.uint32)))
    got = pcamera.pixel_jitter(filt, torch.from_numpy(rnd), torch.from_numpy(it))
    # the filter's tail uses a cube root: pow(s, 1/3) here, cbrt in JAX
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODULE_ATOL, err_msg=filt)


def test_lane_payload_matches_jax(jax_scene, port_scene):
  ids = np.arange(4096) + 3 * 1024
  want = jpt.make_lane_payload(jax_scene[0], jax_scene[1], jnp.asarray(ids, jnp.int32),
                               jnp.int32(4000 + 3 * 1024))
  got = ppt.make_lane_payload(port_scene[0], port_scene[1], torch.from_numpy(ids),
                              4000 + 3 * 1024)
  np.testing.assert_array_equal(got.rng_state.numpy().astype(np.uint32), np.asarray(want.rng_state))
  np.testing.assert_array_equal(got.sample_iter.numpy(), np.asarray(want.sample_iter))
  np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
  for name in ("ray_o", "ray_d", "t_min", "t_max", "throughput", "psh_tmax"):
    np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                               rtol=1e-6, atol=MODULE_ATOL, err_msg=name)


def _points_in_box(rng, n):
  p = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n, 3)).astype(np.float32)
  return p


def test_emitter_sampling_matches_jax(jax_scene, port_scene):
  rng = np.random.default_rng(2)
  n = 4096
  rnd = rng.uniform(size=n).astype(np.float32)
  rnd2 = rng.uniform(size=(n, 2)).astype(np.float32)
  pts = _points_in_box(rng, n)
  js, ps = jax_scene[0], port_scene[0]
  jidx, jpdf = jemitters.sample_emitter_index(js, jnp.asarray(rnd))
  pidx, ppdf = pemitters.sample_emitter_index(ps, torch.from_numpy(rnd))
  np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
  np.testing.assert_array_equal(ppdf.numpy(), np.asarray(jpdf))
  want = jemitters.sample_emitter(js, jidx, jnp.asarray(rnd2), jnp.asarray(pts), jnp.zeros(n),
                                  False, classes=(0,))
  got = pemitters.sample_emitter(ps, pidx, torch.from_numpy(rnd2), torch.from_numpy(pts))
  for name in ("value", "origin", "normal", "direction", "pdf_sample", "pdf_area",
               "pdf_dir", "pdf_dir_out", "is_delta", "triangle_index"):
    np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                               rtol=1e-5, atol=MODULE_ATOL, err_msg=name)


def test_area_radiance_matches_jax(jax_scene, port_scene):
  rng = np.random.default_rng(3)
  n = 4096
  js, ps = jax_scene[0], port_scene[0]
  ei = rng.integers(-1, 2, n).astype(np.int32)       # -1: no emitter
  hit = _points_in_box(rng, n)
  org = _points_in_box(rng, n)
  vis = rng.uniform(size=n) < 0.5
  want = jemitters.area_radiance(js, jnp.asarray(ei), jnp.zeros(n), jnp.asarray(org),
                                 jnp.asarray(hit), jnp.zeros((n, 2)), jnp.asarray(vis), False)
  got = pemitters.area_radiance(ps, torch.from_numpy(ei), torch.from_numpy(org),
                                torch.from_numpy(hit), torch.from_numpy(vis))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=MODULE_ATOL)


def test_diffuse_bsdf_matches_jax(jax_scene, port_scene):
  rng = np.random.default_rng(4)
  n = 4096
  js, ps = jax_scene[0], port_scene[0]

  def unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

  nrm = unit(rng.normal(size=(n, 3)))
  tan = unit(np.cross(nrm, unit(rng.normal(size=(n, 3)))))
  btn = np.cross(nrm, tan).astype(np.float32)
  w_i = unit(rng.normal(size=(n, 3)))
  w_o = unit(rng.normal(size=(n, 3)))
  mat = rng.integers(0, 5, n).astype(np.int32)
  rnd = rng.uniform(size=(n, pdispatch.NUM_SAMPLE_RND)).astype(np.float32)
  jmat = jpacked.unpack_material_rows(jgather.take_rows(js.mat_table, jnp.asarray(mat)))
  jsd = jlobes.ShadingData(w_i=jnp.asarray(w_i), nrm=jnp.asarray(nrm), tan=jnp.asarray(tan),
                           btn=jnp.asarray(btn), geo_n=jnp.asarray(nrm), tex=jnp.zeros((n, 2)),
                           wl=jnp.zeros(n), medium=jnp.full(n, -1, jnp.int32), mat=jmat)
  t = torch.from_numpy
  psd = plobes.ShadingData(w_i=t(w_i), nrm=t(nrm), tan=t(tan), btn=t(btn), geo_n=t(nrm),
                           tex=torch.zeros((n, 2)), wl=torch.zeros(n),
                           medium=torch.full((n,), -1, dtype=torch.int32),
                           mat=ppacked.MaterialRows(ps.mat_table[t(mat).long()]))
  want = jdispatch.sample(js, jsd, jnp.asarray(rnd), False, (0,), (0,))
  got = pdispatch.sample(ps, psd, t(rnd))
  for name in plobes.BSDFSampleR._fields:
    np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                               atol=MODULE_ATOL, err_msg=name)
  for g, w in zip(pdispatch.evaluate(ps, psd, t(w_o)),
                  jdispatch.evaluate(js, jsd, jnp.asarray(w_o), False, (0,), (0,))):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=MODULE_ATOL)
  np.testing.assert_allclose(pdispatch.pdf(ps, psd, t(w_o)).numpy(),
                             np.asarray(jdispatch.pdf(js, jsd, jnp.asarray(w_o), False, (0,))),
                             atol=MODULE_ATOL)
  np.testing.assert_array_equal(pdispatch.albedo(ps, psd).numpy(),
                                np.asarray(jdispatch.albedo(js, jsd, False)))
  np.testing.assert_allclose(
      pdispatch.fix_shading_normal(t(nrm), t(btn), t(w_i), t(w_o)).numpy(),
      np.asarray(jdispatch.fix_shading_normal(jnp.asarray(nrm), jnp.asarray(btn),
                                              jnp.asarray(w_i), jnp.asarray(w_o))),
      rtol=1e-5, atol=MODULE_ATOL)


def test_pt_step_matches_jax(jax_scene, port_scene):
  """Two wavefront bounces with deferred NEE from the same 1024 lanes."""
  ids = np.arange(1024) + 1024
  jst = jpt.make_lane_payload(jax_scene[0], jax_scene[1], jnp.asarray(ids, jnp.int32),
                              jnp.int32(2 ** 30))
  pst = ppt.make_lane_payload(port_scene[0], port_scene[1], torch.from_numpy(ids), 2 ** 30)
  for step in range(2):
    jst = jpt.pt_step(jax_scene[0], jax_scene[1], jst, deferred_nee=True)
    pst = ppt.pt_step(port_scene[0], port_scene[1], pst)
    alive_j, alive_p = np.asarray(jst.alive), pst.alive.numpy()
    # a lane may take the other branch at a triangle edge: allow 1%
    same = (alive_j == alive_p) & (np.asarray(jst.res_valid) == pst.res_valid.numpy())
    assert same.mean() >= 0.99, f"step {step}"
    np.testing.assert_array_equal(pst.rng_state.numpy()[same].astype(np.uint32),
                                  np.asarray(jst.rng_state)[same])
    for name in ("ray_o", "ray_d", "throughput", "accumulated", "view_normal", "view_albedo",
                 "bsdf_pdf", "psh_o", "psh_d", "psh_tmax", "psh_rgb", "res_rgb"):
      g = getattr(pst, name).numpy()[same]
      w = np.asarray(getattr(jst, name))[same]
      close = np.isclose(g, w, rtol=1e-4, atol=1e-4)
      assert close.reshape(close.shape[0], -1).all(axis=1).mean() >= 0.99, (step, name)
    assert float(pst.rays_traced) == pytest.approx(float(jst.rays_traced), rel=0.01)


# --------------------------------------------------------------- main path


def test_render_matches_jax_pixel_by_pixel(jax_golden, port_golden):
  ref, ref_table, ref_rays = jax_golden
  img, table, rays = port_golden
  assert img.shape == ref.shape == (FILM[1], FILM[0], 3)
  assert np.isfinite(img).all() and (img >= 0.0).all()
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.mean() <= OUTLIER_FRACTION, outliers.mean()
  assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())
  # every pixel finished exactly SPP samples on both sides
  np.testing.assert_array_equal(table[:, 12], ref_table[:, 12])
  np.testing.assert_array_equal(table[:, 12], np.full(FILM[0] * FILM[1], SPP))
  assert rays == pytest.approx(ref_rays, rel=0.005)


def test_render_matches_golden_values(port_golden):
  """tests/test_golden.py's checks, at its own tolerances, on the port."""
  img = port_golden[0]
  np.testing.assert_allclose(img.mean(axis=(0, 1)), GOLDEN_MEAN, rtol=2e-3, atol=1e-5)
  np.testing.assert_allclose(float(img.sum()), GOLDEN_TOTAL, rtol=2e-3)
  for (y, x), want in GOLDEN_PROBES.items():
    np.testing.assert_allclose(img[y, x], want, rtol=5e-3, atol=5e-4, err_msg=f"pixel ({y},{x})")


def test_render_entry_point_matches_pooled_sums(port_scene, port_golden):
  """`render` is render_samples_static + finalize_film, and the Cornell box
  looks like one: red left wall, green right wall."""
  scene, config = port_scene
  img = pfilm.result_image(ppt.render(scene, config, iterations=SPP, device="cpu")).numpy()
  np.testing.assert_array_equal(img, port_golden[0])
  third = FILM[0] // 3
  left, right = img[:, :third].mean((0, 1)), img[:, -third:].mean((0, 1))
  assert left[0] > left[1] and right[1] > right[0]


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, port_scene):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  scene, config = port_scene
  with pytest.raises(RuntimeError, match="device='cpu'"):
    default_device()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    pcornell.build_cornell_box(film_size=(8, 8)).build()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    ppt.render(scene, config, iterations=1)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    ppt.render_samples_static(scene, config, 0, 1)


_GUARD = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path=None, target=None):
    if name.split(".")[0] in ("jax", "jaxlib", "etx_tracer_tpu"):
      raise ImportError(f"blocked import of {name}")
    return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
torch.set_num_threads(1)
import chip_smoke
import etx_tracer_tpu_torch
from etx_tracer_tpu_torch.models import path_tracing
from etx_tracer_tpu_torch.render import film
from etx_tracer_tpu_torch.scene import cornell
scene, config = cornell.build_cornell_box(film_size=(8, 8), max_path_length=4).build(device="cpu")
img = film.result_image(path_tracing.render(scene, config, iterations=1, device="cpu"))
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
from etx_tracer_tpu_torch.benchmarks import micro
from etx_tracer_tpu_torch.ops import trace
from etx_tracer_tpu_torch.scene import bigscene, types
big = micro.scene("bigscene", "cpu")  # built once, for micro.run too
assert big.tri_v0.shape == (bigscene.NUM_TRIANGLES, 3)
o = torch.tensor([[0.0, 1.0, 0.0]] * 4)
d = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
t0, t1 = torch.full((4,), 1e-4), torch.full((4,), 1e30)
hit = trace.trace_closest(big, o, d, t0, t1)
assert bool(hit.found.all())
slim = big._replace(bvh=types.without_fat_rows(big.bvh))
assert torch.equal(trace.trace_occluded(slim, o, d, t0, t1), hit.found)
assert "etx_tracer_tpu_torch.ops.bvh_trace" in sys.modules
from etx_tracer_tpu_torch.ops import woop_trace
from etx_tracer_tpu_torch.scene import caustics
cs, _ = caustics.build_caustics_scene((8, 8)).build(device="cpu")
assert cs.tri_v0.shape == (caustics.NUM_TRIANGLES, 3) and cs.bsphere_radius.shape == ()
woop = woop_trace.intersect(cs.tri_v0, cs.tri_e1, cs.tri_e2, o, d, t0, t1)
assert woop.t.shape == (4,) and woop_trace.launches == {"intersect": 0, "occluded": 0}
lines = micro.run("trace_sorted", "cpu", 64)
assert [x.label for x in lines] == ["fat+sort bounce", "fat+sort random"]
from etx_tracer_tpu_torch.scene import volumetric
cloud, cloud_config = volumetric.volumetric((8, 8)).build(device="cpu")
for scene, config in ((cloud, cloud_config),
                      volumetric.subsurface_cornell((8, 8)).build(device="cpu")):
  assert config.has_media or config.has_subsurface
  img = film.result_image(path_tracing.render(scene, config, iterations=1, device="cpu"))
  assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
from etx_tracer_tpu_torch.models import vcm
scene, config = cornell.build_cornell_box(film_size=(8, 8), diffuse_only=True,
                                          max_path_length=4).build(device="cpu")
from etx_tracer_tpu_torch.render import images
from etx_tracer_tpu_torch.scene import atmosphere
sky = atmosphere.atmosphere_scene((8, 8), sky_size=(8, 4)).build(device="cpu")
img = film.result_image(path_tracing.render(*sky, iterations=1, device="cpu"))
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
assert not images.bank_is_empty(sky[0].images)
floor, floor_config = atmosphere.env_floor_scene((8, 8)).build(device="cpu")
for sc, cfg, options in ((scene, config, vcm.VCMOptions()), (cloud, cloud_config, vcm.bdpt_options()),
                         (floor, floor_config, vcm.bdpt_options())):
  img = film.result_image(vcm.render(sc, cfg, options, iterations=1, device="cpu"))
  assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all()) and float(img.sum()) > 0
import dataclasses
from etx_tracer_tpu_torch.core import bluenoise, spectrum
from etx_tracer_tpu_torch.render.bsdf import multiscatter
from etx_tracer_tpu_torch.scene import builder, spectral_data
from tests import shading_showcase
show, show_config = shading_showcase.showcase(cornell, builder, types, spectrum, spectral_data,
                                              film_size=(8, 8), order=0).build(device="cpu")
show_config = dataclasses.replace(show_config, blue_noise=True)
assert show_config.diffuse_variations == (0, 1, 2) and show_config.has_alpha
assert show.material_features and bluenoise.mask_np().shape == (128, 128)
img = film.result_image(path_tracing.render(show, show_config, iterations=1, device="cpu"))
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
img = film.result_image(vcm.render(show, show_config, vcm.VCMOptions(initial_radius=0.2),
                                   iterations=1, device="cpu"))
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
assert spectral_data.led(3000.0).values.max() > 0 and "multiscatter" in multiscatter.__name__
import os, tempfile
from etx_tracer_tpu_torch import cli
from etx_tracer_tpu_torch.models import debug
from etx_tracer_tpu_torch.render import denoiser
from etx_tracer_tpu_torch.scene import assets, gltf_loader
from etx_tracer_tpu_torch.utils import image_io
work = tempfile.mkdtemp(dir=os.environ["XDG_CACHE_HOME"])
os.environ["ETX_TPU_CONFIG_DIR"] = work
scene_file = assets.write_cornell_asset(work)
for extra in ([], ["--adaptive", "--spp", "3"], ["--integrator", "debug", "--aov", "albedo"]):
  out = os.path.join(work, "out.exr")
  cli.main(["render", scene_file, "-o", out, "--size", "8x8", "--max-path", "3", "--spp", "1",
            "--device", "cpu"] + extra)
  img = image_io.load_exr(out)
  assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.max() > 0
fs = path_tracing.render_adaptive(scene, config, max_iterations=2, device="cpu")
assert denoiser.denoise_film(fs).shape == (8, 8, 3) and debug.DebugMode.Count == 18
from etx_tracer_tpu_torch.parallel import mesh
from etx_tracer_tpu_torch.utils import checkpoint, options, profiler, validate
from etx_tracer_tpu_torch.viewer import server
assert mesh.dryrun(2)[0] == (7, 16, 3)
scene, config = cornell.build_cornell_box(film_size=(8, 8), max_path_length=3).build(device="cpu")
preview = path_tracing.render_preview(scene, config, pixel_size=4, device="cpu")
assert preview.shape == (8, 8, 3) and bool(torch.isfinite(preview).all())
from etx_tracer_tpu_torch import native
from etx_tracer_tpu_torch.benchmarks import denoise_eval
from etx_tracer_tpu_torch.render.bsdf import lobes
from etx_tracer_tpu_torch.scene import materials, nvdb, save_mtl
from tests import nvdb_writer
assert native.load() is not None, native.failure()
grid_file = nvdb_writer.write_dense(os.path.join(work, "c.nvdb"), volumetric._expected_grid())
assert nvdb.read_nvdb_density(grid_file).shape == (24, 24, 24)
save_mtl.save_materials(os.path.join(work, "c.mtl"), cornell.build_cornell_box(film_size=(8, 8)))
lobes.MS_BACKEND = "walk"
scene, config = materials.build_materials_scene((8, 8)).build(device="cpu")
img = film.result_image(path_tracing.render(scene, config, iterations=1, device="cpu"))
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
lobes.MS_BACKEND = "lut"
assert [x.label for x in micro.run("sort", "cpu", 16)][0] == "sort_key_val n=16"
assert denoise_eval.run("cpu", size=8, gt_spp=2, spps=(1,), levels=(1,))[0]["spp"] == 1
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "etx_tracer_tpu")]
assert not bad, bad
print("GUARD-OK")
"""


def test_port_and_chip_smoke_import_no_jax(tmp_path):
  env = dict(os.environ)
  env.pop("PYTHONPATH", None)
  env["PYTHONPATH"] = str(REPO)
  env["XDG_CACHE_HOME"] = str(tmp_path)  # the volumetric scene's `.vol` cloud
  out = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
  assert out.returncode == 0, out.stderr[-4000:]
  assert "GUARD-OK" in out.stdout
