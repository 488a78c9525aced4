"""The port's per-iteration, scatter-pool, mapped and adaptive PT drivers
against the JAX package (CPU), on the Cornell scene files.

Both packages load the scene files that `scene/assets.py` writes (the
Cornell box with the silver tall box, 36 triangles) at 16x16 and path
length 4, with 40 spp as `cli render --spp 40` sets them, and freeze the
same tables (tests/test_torch_loaders.py). The noise map is a pure function
of the film sums: `active_pixel_map` must give the JAX map and count bit
for bit on the same sums (seeded tables built to straddle the threshold,
and the JAX warm render's sums). The render drivers are held to the JAX
jitted functions pixel by pixel at tests/test_torch_render.py's tolerances
(at most 2% of the pixels off by more than 1e-4 + 1e-3 |ref|; image means
within 0.5%), each sample count exactly: the scatter pool's 32 warm spp,
one mapped batch of 8 spp from the same sums and the same partial map (the
JAX sums and map carried across), one full-film iteration from the JAX
film after iteration 0, the whole adaptive render (32 warm spp and a
mapped batch), and `cli render --adaptive` against the JAX CLI's EXR.
"""

import numpy as np
import pytest
import torch

from etx_tracer_tpu import cli as jcli
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu_torch import native as pnative
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.render import film as jfilm
from etx_tracer_tpu.scene import json_scene as jjson
from etx_tracer_tpu.utils import image_io as jio
from etx_tracer_tpu_torch import cli as pcli
from etx_tracer_tpu_torch import scene_bridge
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.scene import assets as passets
from etx_tracer_tpu_torch.scene import json_scene as pjson
from etx_tracer_tpu_torch.utils import image_io as pio
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FILM, MPL, SPP = (16, 16), 4, 40   # the scene files as `cli render` sets them
WARM, BATCH = 32, 8                # the adaptive render's warm spp and batch
MAP_THRESHOLD = 0.15               # the mapped test's partial map
OUTLIER_FRACTION = 0.02            # pixels off by > 1e-4 + 1e-3 |ref|
MEAN_RTOL = 0.005


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
  return passets.write_cornell_asset(str(tmp_path_factory.mktemp("cornell")))


def _sized(builder):
  builder.film_size, builder.max_path_length, builder.samples = FILM, MPL, SPP
  return builder


@pytest.fixture(scope="module")
def scenes(scene_file):
  """((JAX scene, config), (port scene, config)) from the scene files."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "parse_obj_native", lambda *a, **k: None)
    mp.setattr(pnative, "parse_obj_native", lambda *a, **k: None)
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    jax = _sized(jjson.load_scene(scene_file)).build()
  return jax, _sized(pjson.load_scene(scene_file)).build(device="cpu")


@pytest.fixture(scope="module")
def warm(scenes):
  """The scatter pool's 32 warm spp: (JAX table, JAX rays, port table, port rays)."""
  (js, jc), (ps, pc) = scenes
  jsums, jrays = jpt.render_samples(js, jc, 0, WARM)
  psums, prays = ppt.render_samples(ps, pc, 0, WARM, device="cpu")
  return np.asarray(jsums.table), float(jrays), psums.table.numpy(), int(prays)


def assert_close_image(got, want, what, mean=True):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape and np.isfinite(got).all(), what
  bad = np.abs(got - want) > 1e-4 + 1e-3 * np.abs(want)
  frac = bad.any(axis=-1).mean() if got.ndim > 1 else bad.mean()
  assert frac <= OUTLIER_FRACTION, f"{what}: {frac:.4f} of the pixels off"
  if mean:
    assert abs(got.mean() - want.mean()) <= MEAN_RTOL * abs(want.mean()), what


def assert_close_sums(got, want, what):
  """Sums tables: the sample and even-sample counts exactly, the camera,
  normal and albedo sums pixel by pixel."""
  np.testing.assert_array_equal(got[:, 12:14], want[:, 12:14], err_msg=what)
  for lo, hi, layer in ((0, 3, "camera"), (3, 6, "normals"), (6, 9, "albedo"),
                        (9, 12, "variance")):
    assert_close_image(got[:, lo:hi], want[:, lo:hi], f"{what}: {layer}")


def _straddling_sums(seed, npix, threshold):
  """A sums table whose noise estimates sit within 2% of `threshold` on a
  few pixels (the rest well below it), some pixels with no samples."""
  rs = np.random.default_rng(seed)
  table = np.zeros((npix, 14), np.float32)
  count = rs.integers(0, 40, npix).astype(np.float32)
  vcount = np.floor(count / 2).astype(np.float32)
  full = rs.random((npix, 3)).astype(np.float32) + 0.01
  near = rs.random(npix) < 0.03
  noise = (threshold * np.where(near, rs.uniform(0.98, 1.02, npix), 0.2)).astype(np.float32)
  half = full * (1.0 + noise[:, None] * rs.choice([-1.0, 1.0], (npix, 1)))
  table[:, 0:3] = full * count[:, None]
  table[:, 9:12] = half * vcount[:, None]
  table[:, 12], table[:, 13] = count, vcount
  return table


@pytest.mark.parametrize("width,height,threshold", [(16, 16, 0.1), (12, 7, 0.05),
                                                    (16, 16, 0.4), (9, 9, 10.0)])
def test_active_pixel_map_bit_equal_jax(width, height, threshold):
  table = _straddling_sums(width * height, width * height, threshold)
  jmap, jn = jpt.active_pixel_map(jpt.FilmSums(table), width, threshold)
  pmap, pn = ppt.active_pixel_map(scene_bridge.film_sums_from_numpy(table, "cpu"), width,
                                  threshold)
  assert int(pn) == int(jn) and pmap.dtype == torch.int64
  np.testing.assert_array_equal(pmap.numpy(), np.asarray(jmap))
  if threshold > 1.0:
    assert int(pn) == 0 and not pmap.any()
  else:
    assert 0 < int(pn) < width * height


def test_active_pixel_map_bit_equal_jax_on_the_warm_sums(warm):
  jtable = warm[0]
  for threshold in (0.1, MAP_THRESHOLD, 0.3):
    jmap, jn = jpt.active_pixel_map(jpt.FilmSums(jtable), FILM[0], threshold)
    pmap, pn = ppt.active_pixel_map(scene_bridge.film_sums_from_numpy(jtable, "cpu"), FILM[0],
                                    threshold)
    assert int(pn) == int(jn)
    np.testing.assert_array_equal(pmap.numpy(), np.asarray(jmap))


def test_render_samples_matches_jax(warm):
  jtable, jrays, ptable, prays = warm
  assert (ptable[:, 12] == WARM).all() and (ptable[:, 13] == WARM // 2).all()
  assert_close_sums(ptable, jtable, "render_samples")
  assert abs(prays - jrays) <= 0.005 * jrays


def test_render_samples_mapped_matches_jax_from_one_map(scenes, warm):
  """One mapped batch from the JAX warm sums and the JAX map of a partial
  threshold: pixels repeat in the map, each repeat its own RNG stream."""
  (js, jc), (ps, pc) = scenes
  jtable = warm[0]
  jmap, jn = jpt.active_pixel_map(jpt.FilmSums(jtable), FILM[0], MAP_THRESHOLD)
  assert 0 < int(jn) < FILM[0] * FILM[1]
  jsums, jrays = jpt.render_samples_mapped(js, jc, jmap, WARM, BATCH, jpt.FilmSums(jtable))
  psums, prays = ppt.render_samples_mapped(ps, pc, torch.from_numpy(np.asarray(jmap)), WARM,
                                           BATCH, scene_bridge.film_sums_from_numpy(jtable, "cpu"),
                                           device="cpu")
  got, want = psums.table.numpy(), np.asarray(jsums.table)
  assert (got[:, 12] - jtable[:, 12]).sum() == BATCH * FILM[0] * FILM[1]
  assert_close_sums(got, want, "render_samples_mapped")
  assert abs(int(prays) - float(jrays)) <= 0.005 * float(jrays)


def test_render_iteration_matches_jax(scenes):
  """Iteration 1 over the JAX film of iteration 0, and iteration 0 from an
  empty film. Iteration 0's rays leave the pixel centres, and a few of them
  meet the room's corner edges, where the two packages may hit different
  triangles: that one-sample image is held by its outlier count only (one
  such pixel of 256 moves its mean by about 0.5%)."""
  (js, jc), (ps, pc) = scenes
  fs0 = jpt.render_iteration_stats(js, jc, jfilm.allocate(*FILM), 0)[0]
  want, jrays = jpt.render_iteration_stats(js, jc, fs0, 1)
  got, prays = ppt.render_iteration_stats(
      ps, pc, scene_bridge.film_state_from_numpy(fs0._asdict(), "cpu"), 1, device="cpu")
  assert int(got.iteration) == int(want.iteration) == 2
  for layer in ("camera", "variance_half", "normals", "albedo"):
    assert_close_image(getattr(got, layer).numpy(), np.asarray(getattr(want, layer)), layer)
  assert abs(int(prays) - float(jrays)) <= 0.005 * float(jrays)
  own = ppt.render_iteration(ps, pc, pfilm.allocate(*FILM, "cpu"), 0, device="cpu")
  assert_close_image(own.camera.numpy(), np.asarray(fs0.camera), "iteration 0", mean=False)


def test_render_adaptive_matches_jax(scenes, monkeypatch):
  (js, jc), (ps, pc) = scenes
  active = []
  pmap = ppt.active_pixel_map

  def mapped(*args):
    out = pmap(*args)
    active.append(int(out[1]))
    return out

  monkeypatch.setattr(ppt, "active_pixel_map", mapped)
  want = jpt.render_adaptive(js, jc, max_iterations=SPP)
  got = ppt.render_adaptive(ps, pc, max_iterations=SPP, device="cpu")
  assert active == [FILM[0] * FILM[1]]  # one batch; every pixel noisy at 32 spp
  assert int(got.iteration) == int(want.iteration) == SPP
  for layer in ("camera", "variance_half", "normals", "albedo"):
    assert_close_image(getattr(got, layer).numpy(), np.asarray(getattr(want, layer)), layer)


def test_cli_adaptive_matches_jax_cli(scene_file, tmp_path, monkeypatch):
  monkeypatch.setenv("ETX_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
  monkeypatch.setattr(jnative, "parse_obj_native", lambda *a, **k: None)
  monkeypatch.setattr(pnative, "parse_obj_native", lambda *a, **k: None)
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
  args = ["render", scene_file, "--size", "x".join(map(str, FILM)), "--max-path", str(MPL),
          "--spp", str(SPP), "--adaptive"]
  j_out, p_out = str(tmp_path / "jax.exr"), str(tmp_path / "port.exr")
  jcli.main(args + ["-o", j_out])
  pcli.main(args + ["-o", p_out, "--device", "cpu"])
  want, got = jio.load_exr(j_out), pio.load_exr(p_out)
  assert got.shape == (FILM[1], FILM[0], 3)
  assert_close_image(got, want, "cli render --adaptive")
