"""The port's VCM slice against the JAX package (CPU): the film functions,
the light-to-camera connection, light-path emission, the reverse pdf, the
radius schedule, the merge grid, both passes, and whole VCM, BDPT,
BDPTFast and light-tracing renders of the 16x16 diffuse Cornell box.

Both packages get the same inputs, made from numpy seeds, and scenes built
by the same numpy code (the JAX tree by its numpy builder). Closed-form
functions are held within MODULE_RTOL relative (MODULE_ATOL absolute near
zero). The radius schedule and the merge grid on vertices carried across
from the JAX package must be bit-equal (in spectral mode but for the
throughput's RGB, within PASS_RTOL). The light pass must return the JAX
package's RNG states, its vertices within PASS_RTOL on at least
PASS_LANES of the slots and within PASS_RTOL_ALL everywhere: the MIS
recurrences (d_vcm, d_vc, d_vm) chain a division per bounce, and a few
slots of a 16x16 pass part from the JAX package's fused arithmetic by just
over 1e-5. Both passes run with `_CAMERA_CASCADE_MIN` set to 64 in both
packages, so that their compaction cascades run at 16x16 (256 -> 64
lanes).

Whole renders are held to the JAX package's jitted render pixel by pixel:
at most OUTLIER_FRACTION of the pixels off by more than 1e-4 + 1e-3 |ref|,
the image mean within MEAN_RTOL and the rays traced within RAYS_RTOL.
Renders that merge run with `max_photons_per_cell=UNCAPPED`, a cap above
every cell's occupancy: every photon is kept and the merge scans each cell
to its end. With the default cap of 16, an over-full cell keeps the first
photons in the order of a hash of their positions' bits, so a one-ulp
change of one light vertex changes which photons a cell keeps
(test_capped_cells_keep_other_photons_after_one_ulp), and two renders
that round a light vertex apart (the JAX package's jitted and eager runs
among them) differ wherever they merge such a cell. (A cap of 0 does not help: the scan then stops at
`_MERGE_SCAN_CAP` photons a cell, chosen in the same order.) The capped
merge is held by the bit-equal grid build and by the camera pass on the
JAX package's vertices and grid, within PASS_RTOL.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import scenes as jscenes
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.models import vcm as jvcm
from etx_tracer_tpu.render import camera as jcamera
from etx_tracer_tpu.render import emitters as jemitters
from etx_tracer_tpu.render import film as jfilm
from etx_tracer_tpu.render.bsdf import dispatch as jdispatch
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu_torch.models import vcm as pvcm
from etx_tracer_tpu_torch.render import camera as pcamera
from etx_tracer_tpu_torch.render import emitters as pemitters
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.render.bsdf import dispatch as pdispatch
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.scene import materials as pmaterials
from tests.test_torch_materials import _shading
from tests.test_torch_render import _jax_arrays
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FILM, SPP, MPL = (16, 16), 2, 4   # the whole-render comparisons
MODULE_RTOL = 1e-6                # closed-form functions
MODULE_ATOL = 1e-6
PASS_RTOL = 1e-5                  # the passes' outputs
PASS_ATOL = 1e-6
PASS_LANES = 0.99                 # ... on this share of the vertex slots
PASS_RTOL_ALL = 1e-4              # ... and this everywhere
OUTLIER_FRACTION = 0.02           # whole render: pixels off by > 1e-4 + 1e-3 |ref|
MEAN_RTOL = 0.005                 # whole render: image mean
RAYS_RTOL = 0.01                  # whole render: rays traced
ITERATION = 1                     # the passes' iteration
CASCADE_MIN = 64                  # both packages' cascade floor in the pass tests
UNCAPPED = 1 << 20                # the renders' photon cap (see above)


def _t(x):
  return torch.from_numpy(np.array(x))


def _close(got, want, what, rtol=MODULE_RTOL, atol=MODULE_ATOL):
  np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                             rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def scenes():
  """{spectral: ((JAX scene, config), (port scene, config))} of the 16x16
  diffuse Cornell box, path length 4."""
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    for spectral in (False, True):
      kw = dict(film_size=FILM, diffuse_only=True, max_path_length=MPL, spectral=spectral)
      out[spectral] = (jcornell.build_cornell_box(**kw).build(),
                       pcornell.build_cornell_box(**kw).build(device="cpu"))
  return out


@pytest.fixture
def cascade(monkeypatch):
  """Both packages' cascade floor at CASCADE_MIN."""
  monkeypatch.setattr(jvcm, "_CAMERA_CASCADE_MIN", CASCADE_MIN)
  monkeypatch.setattr(pvcm, "_CAMERA_CASCADE_MIN", CASCADE_MIN)
  assert pvcm._cascade_widths(FILM[0] * FILM[1]) == [256, 64]


def _sched(scene, config, options, iteration):
  return tuple(float(x) for x in pvcm.radius_schedule(scene, config, options, iteration))


def _jax_light(scenes, spectral, options=None):
  """The JAX package's light pass at ITERATION: (vertices, splat, state)."""
  (jscene, jconfig), (pscene, pconfig) = scenes[spectral]
  options = options or pvcm.VCMOptions()
  _, vcw, vmw, _ = _sched(pscene, pconfig, options, ITERATION)
  return jvcm.light_pass(jscene, jconfig, jvcm.VCMOptions(**dataclasses.asdict(options)),
                         ITERATION, FILM[0] * FILM[1], jnp.float32(vcw), jnp.float32(vmw))


@pytest.fixture(scope="module")
def jax_light(scenes):
  """{spectral: `_jax_light`} without the cascade, computed once a module
  (its vertices and wavelengths do not depend on the cascade)."""
  return {spectral: _jax_light(scenes, spectral) for spectral in (False, True)}


def _carried(jverts):
  return pvcm.LightVertices(*(_t(x) for x in jverts))


# ------------------------------------------------------------ small modules


def test_camera_tables_match_jax(scenes):
  """The port's builder freezes the JAX package's projection, image area
  and lens."""
  want = _jax_arrays(scenes[False][0][0])
  cam = scenes[False][1][0].camera
  for f in ("view_proj", "area", "lens_radius", "focal_distance"):
    got = getattr(cam, f).numpy()
    assert got.dtype == want[f"camera.{f}"].dtype
    np.testing.assert_array_equal(got, want[f"camera.{f}"], err_msg=f)


def test_sample_film_and_film_pdf_out_match_jax(scenes):
  """Points inside and outside the view, and the pdf of camera directions."""
  (jscene, _), (pscene, _) = scenes[False]
  rng = np.random.default_rng(40)
  n = 4096
  pts = rng.uniform(-1.2, 2.2, (n, 3)).astype(np.float32)
  lens = rng.uniform(size=(n, 2)).astype(np.float32)
  got = pcamera.sample_film(pscene.camera, _t(pts), _t(lens))
  want = jcamera.sample_film(jscene.camera, jnp.asarray(pts), jnp.asarray(lens))
  np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
  assert 0.2 < got.valid.numpy().mean() < 0.9
  for f in ("position", "normal", "direction", "uv", "weight", "pdf_dir"):
    _close(getattr(got, f), getattr(want, f), f)
  _close(pcamera.film_pdf_out(pscene.camera, _t(pts)),
         jcamera.film_pdf_out(jscene.camera, jnp.asarray(pts)), "film_pdf_out")


@pytest.mark.parametrize("spectral", [False, True])
def test_sample_emission_matches_jax(scenes, spectral):
  (jscene, _), (pscene, _) = scenes[spectral]
  rng = np.random.default_rng(41)
  n = 4096
  sel, wl = rng.uniform(size=n).astype(np.float32), rng.uniform(390, 830, n).astype(np.float32)
  pos, d = (rng.uniform(size=(n, 2)).astype(np.float32) for _ in range(2))
  if not spectral:
    wl = np.zeros(n, np.float32)
  got = pemitters.sample_emission(pscene, _t(sel), _t(pos), _t(d), _t(wl), spectral)
  want = jemitters.sample_emission(jscene, *(jnp.asarray(x) for x in (sel, pos, d, wl)),
                                   spectral)
  for f in ("is_delta", "is_distant", "triangle_index", "medium_index"):
    np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
  for f in ("value", "origin", "normal", "direction", "pdf_sample", "pdf_area", "pdf_dir",
            "pdf_dir_out", "geo_n"):
    _close(getattr(got, f), getattr(want, f), f)
  assert (got.pdf_dir.numpy() > 0).all() and (got.value.numpy() > 0).all()


@pytest.mark.parametrize("spectral", [False, True])
def test_reverse_pdf_matches_jax(spectral):
  """Over the materials scene's Diffuse, Conductor and Dielectric rows, a
  quarter of them rough."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    jscene, jconfig = jscenes.materials((8, 8), spectral=spectral).build()
  pscene, _ = pmaterials.build_materials_scene((8, 8), spectral=spectral).build(device="cpu")
  classes = (0, 3, 4)
  rng = np.random.default_rng(42)
  jsd, psd, _ = _shading(rng, 4096, jscene, pscene, spectral, classes)
  w_o = rng.normal(size=(4096, 3))
  w_o = (w_o / np.linalg.norm(w_o, axis=1, keepdims=True)).astype(np.float32)
  got = pdispatch.reverse_pdf(pscene, psd, _t(w_o), spectral, classes)
  want = jdispatch.reverse_pdf(jscene, jsd, jnp.asarray(w_o), spectral, classes)
  # a few spectral Conductor lanes (4 of 4,096) part at up to 1.2e-5
  close = np.isclose(got.numpy(), np.asarray(want), rtol=MODULE_RTOL, atol=MODULE_ATOL)
  assert close.mean() >= 0.999, close.mean()
  _close(got, want, "reverse_pdf", rtol=1e-4, atol=1e-5)
  assert (got.numpy() > 0).mean() > 0.2


def test_film_functions_match_jax():
  rng = np.random.default_rng(43)
  w, h = 12, 10
  pf, jf = pfilm.allocate(w, h, "cpu"), jfilm.allocate(w, h)
  for _ in range(3):
    c, nrm, alb = (rng.uniform(size=(h, w, 3)).astype(np.float32) for _ in range(3))
    pf = pfilm.accumulate_camera(pf, _t(c), _t(nrm), _t(alb))
    jf = jfilm.accumulate_camera(jf, *(jnp.asarray(x) for x in (c, nrm, alb)))
    uv = rng.uniform(-1.2, 1.2, (500, 2)).astype(np.float32)
    vals = rng.uniform(size=(500, 3)).astype(np.float32)
    pf = pfilm.splat_light(pf, _t(uv), _t(vals))
    jf = jfilm.splat_light(jf, jnp.asarray(uv), jnp.asarray(vals))
    _close(pf.light_iteration, jf.light_iteration, "splat_light")
    pf = pfilm.commit_light_iteration(pf)
    jf = jfilm.commit_light_iteration(jf)
  for f in pfilm.FilmState._fields:
    _close(getattr(pf, f), getattr(jf, f), f)
  _close(pfilm.noise_estimate(pf), jfilm.noise_estimate(jf), "noise_estimate")
  active = rng.uniform(size=(h, w)) < 0.05
  np.testing.assert_array_equal(pfilm.dilate_mask(_t(active)).numpy(),
                                np.asarray(jfilm.dilate_mask(jnp.asarray(active))))
  counts = rng.integers(1, 9, (h, w)).astype(np.float32)
  c = rng.uniform(size=(h, w, 3)).astype(np.float32)
  got, gc = pfilm.accumulate_camera_masked(pf, _t(c), _t(counts), _t(active))
  want, wc = jfilm.accumulate_camera_masked(jf, jnp.asarray(c), jnp.asarray(counts),
                                            jnp.asarray(active))
  for f in pfilm.FilmState._fields:
    _close(getattr(got, f), getattr(want, f), f)
  np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("options", ["vcm", "bdpt", "radius"])
def test_radius_schedule_is_bit_equal(scenes, options):
  (jscene, jconfig), (pscene, pconfig) = scenes[False]
  o = {"vcm": pvcm.VCMOptions(), "bdpt": pvcm.bdpt_options(),
       "radius": pvcm.VCMOptions(initial_radius=0.07, radius_decay=100)}[options]
  jo = jvcm.VCMOptions(**dataclasses.asdict(o))
  for it in (0, 1, 7, 1000):
    got = pvcm.radius_schedule(pscene, pconfig, o, it)
    want = jvcm.radius_schedule(jscene, jconfig, jo, it)
    for g, w in zip(got, want):
      assert g.dtype == np.float32
      assert np.asarray(g).view(np.uint32) == np.asarray(w, np.float32).view(np.uint32), it


# ------------------------------------------------------------ merge grid


@pytest.mark.parametrize("spectral", [False, True])
def test_merge_grid_is_bit_equal(scenes, jax_light, spectral):
  """On the JAX package's light vertices and wavelengths: the same sort
  (cells, photons) and the same packed rows, with cells over the cap."""
  (jscene, _), (pscene, pconfig) = scenes[spectral]
  jverts, _, jstate = jax_light[spectral]
  radius = _sched(pscene, pconfig, pvcm.VCMOptions(), ITERATION)[0]
  got = pvcm.build_merge_grid(pscene, _carried(jverts), _t(jstate.wl), radius, spectral, 16)
  want = jvcm.build_merge_grid(jscene, jverts, jstate.wl, jnp.float32(radius), spectral, 16)
  np.testing.assert_array_equal(got.sorted_cell.numpy(), np.asarray(want.sorted_cell))
  for f in ("pos", "nrm", "w_i", "d_vcm", "d_vm", "path_length", "valid", "grid_min"):
    np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
  np.testing.assert_array_equal(got.rows[:, :11].numpy(), np.asarray(want.rows)[:, :11])
  np.testing.assert_array_equal(got.rows[:, 14:].numpy(), np.asarray(want.rows)[:, 14:])
  # in spectral mode the throughput's RGB goes through the CIE fit, whose
  # exponentials round apart from XLA's by an ulp or two
  _close(got.rows[:, 11:14], np.asarray(want.rows)[:, 11:14], "rows thr", rtol=PASS_RTOL)
  _close(got.throughput_rgb, want.throughput_rgb, "throughput_rgb", rtol=PASS_RTOL)
  if not spectral:
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
  assert got.cell_size == float(want.cell_size)
  _, occ = np.unique(got.sorted_cell.numpy()[got.sorted_cell.numpy() <= pvcm._HASH_MASK],
                     return_counts=True)
  assert occ.max() > 16 and got.valid.sum() < (got.sorted_cell <= pvcm._HASH_MASK).sum()


def test_capped_cells_keep_other_photons_after_one_ulp(scenes, jax_light):
  """Why the renders that merge turn the cap off: moving every vertex by
  one ulp in x changes which photons the over-full cells keep."""
  (_, _), (pscene, pconfig) = scenes[False]
  jverts, _, jstate = jax_light[False]
  verts = _carried(jverts)
  radius = _sched(pscene, pconfig, pvcm.VCMOptions(), ITERATION)[0]
  a = pvcm.build_merge_grid(pscene, verts, _t(jstate.wl), radius, False, 16)
  x = verts.pos[..., 0]
  nudged = verts._replace(pos=torch.stack([torch.nextafter(x, x + 1), verts.pos[..., 1],
                                           verts.pos[..., 2]], dim=-1))
  b = pvcm.build_merge_grid(pscene, nudged, _t(jstate.wl), radius, False, 16)
  kept_a = set(map(tuple, a.pos[a.valid].numpy().round(4).tolist()))
  kept_b = set(map(tuple, b.pos[b.valid].numpy().round(4).tolist()))
  assert kept_a != kept_b


# ------------------------------------------------------------ the passes


@pytest.mark.parametrize("spectral", [False, True])
def test_light_pass_matches_jax(scenes, cascade, spectral):
  (jscene, jconfig), (pscene, pconfig) = scenes[spectral]
  o = pvcm.VCMOptions()
  _, vcw, vmw, _ = _sched(pscene, pconfig, o, ITERATION)
  verts, splat, state = pvcm.light_pass(pscene, pconfig, o, ITERATION, 256, vcw, vmw)
  jverts, jsplat, jstate = _jax_light(scenes, spectral)
  assert state.alive.shape == (64,)  # the tail ran compacted
  np.testing.assert_array_equal(state.rng_state.numpy().astype(np.uint32),
                                np.asarray(jstate.rng_state))
  _close(state.wl, jstate.wl, "wl", rtol=PASS_RTOL, atol=0.0)
  assert int(state.rays_traced) == int(jstate.rays_traced)
  for f in pvcm.LightVertices._fields:
    g = getattr(verts, f).numpy().astype(np.float64)
    w = np.asarray(getattr(jverts, f)).astype(np.float64)
    close = np.isclose(g, w, rtol=PASS_RTOL, atol=PASS_ATOL)
    slots = close.reshape(close.shape[0], close.shape[1], -1).all(axis=-1)
    assert slots.mean() >= PASS_LANES, (f, slots.mean())
    _close(g, w, f, rtol=PASS_RTOL_ALL, atol=PASS_ATOL)
  assert verts.valid.numpy().mean() > 0.2
  _close(splat, jsplat, "splat", rtol=PASS_RTOL, atol=PASS_ATOL)
  assert (splat.numpy() != 0).any(axis=-1).mean() > 0.3


@pytest.mark.parametrize("spectral", [False, True])
def test_camera_pass_matches_jax(scenes, jax_light, cascade, spectral):
  """On the JAX package's vertices and capped grid: the camera RGB and the
  rays traced."""
  (jscene, jconfig), (pscene, pconfig) = scenes[spectral]
  o = pvcm.VCMOptions()
  radius, vcw, vmw, vmn = _sched(pscene, pconfig, o, ITERATION)
  jverts, _, jstate = jax_light[spectral]
  jgrid = jvcm.build_merge_grid(jscene, jverts, jstate.wl, jnp.float32(radius), spectral, 16)
  grid = pvcm.build_merge_grid(pscene, _carried(jverts), _t(jstate.wl), radius, spectral, 16)
  got, rays = pvcm.camera_pass(pscene, pconfig, o, ITERATION, _carried(jverts), grid, radius,
                               vcw, vmw, vmn, return_rays=True)
  want, wrays = jvcm.camera_pass(jscene, jconfig, jvcm.VCMOptions(), ITERATION, jverts, jgrid,
                                 *(jnp.float32(x) for x in (radius, vcw, vmw, vmn)),
                                 return_rays=True)
  _close(got, want, "camera rgb", rtol=PASS_RTOL, atol=PASS_ATOL)
  assert int(rays) == int(wrays)
  assert (got.numpy() != 0).any(axis=-1).mean() > 0.5


# ------------------------------------------------------------ whole renders


_RENDERS = {"vcm": (False, "VCMOptions"), "bdpt": (False, "bdpt_options"),
            "bdpt_fast": (False, "bdpt_fast_options"),
            "light_tracing": (False, "light_tracing_options"),
            "vcm_spectral": (True, "VCMOptions")}


def _render_pair(jscene, jconfig, pscene, pconfig, options, first, spp):
  """(port image, JAX image, port rays, JAX rays) of iterations first ..
  first + spp - 1, each package's film from zero."""
  jo = jvcm.VCMOptions(**dataclasses.asdict(options))
  pf, jf = pfilm.allocate(*FILM, "cpu"), jfilm.allocate(*FILM)
  rays = jrays = 0
  for it in range(first, first + spp):
    pf, r = pvcm.render_iteration_stats(pscene, pconfig, options, pf, it, device="cpu")
    jf, jr = jvcm.render_iteration_stats(jscene, jconfig, jo, jf, it)
    rays, jrays = rays + int(r), jrays + float(jr)
  return pfilm.result_image(pf).numpy(), np.asarray(jfilm.result_image(jf)), rays, jrays


def check_render(img, ref, rays, ref_rays):
  assert img.shape == ref.shape
  assert np.isfinite(img).all()
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.mean() <= OUTLIER_FRACTION, outliers.mean()
  assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())
  assert rays == pytest.approx(ref_rays, rel=RAYS_RTOL)


@pytest.mark.parametrize("name", list(_RENDERS))
def test_render_matches_jax_pixel_by_pixel(scenes, name):
  spectral, factory = _RENDERS[name]
  (jscene, jconfig), (pscene, pconfig) = scenes[spectral]
  options = dataclasses.replace(getattr(pvcm, factory)(), max_photons_per_cell=UNCAPPED)
  img, ref, rays, ref_rays = _render_pair(jscene, jconfig, pscene, pconfig, options, 0, SPP)
  check_render(img, ref, rays, ref_rays)
  if not spectral:
    assert (img >= 0.0).all()
  third = FILM[0] // 3
  left, right = img[:, :third].mean((0, 1)), img[:, -third:].mean((0, 1))
  assert left[0] > left[1] and right[1] > right[0]


def test_render_entry_points(scenes):
  """`render` is `render_iteration` from 0; `render_chunk(_stats)` loop
  over it; a render wants the card unless asked for the CPU."""
  pscene, pconfig = scenes[False][1]
  o = pvcm.bdpt_options()
  fs = pvcm.render(pscene, pconfig, o, iterations=2, device="cpu")
  chunk, rays = pvcm.render_chunk_stats(pscene, pconfig, o, pfilm.allocate(16, 16, "cpu"), 0, 2,
                                        device="cpu")
  for f in pfilm.FilmState._fields:
    assert torch.equal(getattr(fs, f), getattr(chunk, f)), f
  again = pvcm.render_chunk(pscene, pconfig, o, pfilm.allocate(16, 16, "cpu"), 0, 2,
                            device="cpu")
  assert torch.equal(again.camera, fs.camera) and int(fs.iteration) == 2
  assert int(rays) > 2 * 256
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="device='cpu'"):
      pvcm.render(pscene, pconfig, o, iterations=1)


def test_render_adaptive_matches_jax(scenes):
  """Adaptive BDPT: warm-up iterations, then camera passes on the pixels
  that have not converged; the counts and the image as the JAX package's."""
  (jscene, jconfig), (pscene, pconfig) = scenes[False]
  # a threshold that some pixels pass after two iterations of 16x16
  jconfig = dataclasses.replace(jconfig, noise_threshold=0.3)
  pconfig = dataclasses.replace(pconfig, noise_threshold=0.3)
  o = pvcm.bdpt_options()
  fs, counts = pvcm.render_adaptive(pscene, pconfig, o, max_iterations=4, min_samples=2,
                                    device="cpu")
  jfs, jcounts = jvcm.render_adaptive(jscene, jconfig, jvcm.bdpt_options(), max_iterations=4,
                                      min_samples=2)
  np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
  assert (counts.numpy() < 4).any() and (counts.numpy() == 4).any()
  img, ref = pfilm.result_image(fs).numpy(), np.asarray(jfilm.result_image(jfs))
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.mean() <= OUTLIER_FRACTION
  assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())
