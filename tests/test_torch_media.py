"""The port's media slice against the JAX package (CPU).

Bench config 4 (`benchmarks/scenes.py:volumetric`: the diffuse Cornell box
in a heterogeneous cloud loaded back from a `.vol` file), a homogeneous fog,
and a fog with a Boundary cube holding a second medium and a radiance clamp
(`scene/volumetric.fog_boundary_cornell`, staged here with the JAX builder
by the same steps). The modules: the density loader, the medium table, the
HG phase function, channel MIS, the trilinear density lookup, free-path
sampling (analytic and delta tracking), ratio-tracked transmittance, and
the non-deferred bounce.

Both packages get the same inputs, made from numpy seeds. Scene tables are
built by the same numpy code on both sides and must be equal. Module
outputs are held to the JAX package run eagerly: within MODULE_RTOL
relative (MODULE_ATOL absolute near zero) for the closed-form functions,
SAMPLE_RTOL for the tracking loops, whose returned RNG states must be
equal: every lane's stream after a loop depends on the loop's trip count
over the whole wavefront. Whole renders are held to the JAX package's
jitted render pixel by pixel at tests/test_torch_render.py's tolerances,
over iterations FIRST to FIRST + SPP - 1. Iteration 0 is left out: its
Blackman-Harris samples are pixel centres, and a square Cornell film's
diagonal pixel centres aim exactly at the room's corner edges, where two
triangles tie and a one-ulp difference in the camera ray (XLA's rsqrt
against a correctly rounded 1 / sqrt) hands the hit to the other wall. In a
render without wavefront loops that moves one pixel; with media it can
change a loop's trip count, and with it every lane's later stream (16x16,
2 spp from iteration 0: 78% of the pixels differ, the means by 0.7%);
test_iteration_zero_parts_from_jax_only_through_the_corner_rays pins that
cause down.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import scenes as jscenes
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.ops import trace as jtrace
from etx_tracer_tpu.render import media as jmedia
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.scene import obj_loader as jloader
from etx_tracer_tpu.scene import types as jtypes
from etx_tracer_tpu.scene.builder import MaterialDesc as JMaterialDesc
from etx_tracer_tpu.scene.builder import MediumDesc as JMediumDesc
from etx_tracer_tpu.core import spectrum as jspec
from etx_tracer_tpu_torch import scene_bridge
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.ops import brute_trace
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.render import media as pmedia
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.scene import obj_loader as ploader
from etx_tracer_tpu_torch.scene import types as ptypes
from etx_tracer_tpu_torch.scene import volumetric as pvol
from tests.test_torch_render import _jax_arrays
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FILM, SPP, MPL, POOL = (16, 16), 2, 6, 256  # the whole-render comparisons
FIRST = 1                                   # their first iteration (see above)
MODULE_RTOL = 1e-6                          # closed-form functions
MODULE_ATOL = 1e-7
SAMPLE_RTOL = 1e-5                          # tracking loops' outputs
SAMPLE_ATOL = 1e-6
OUTLIER_FRACTION = 0.02                     # whole render: pixels off by > 1e-4 + 1e-3 |ref|
MEAN_RTOL = 0.005                           # whole render: image mean
LANES = 4096
STEPS = 3                                   # bounces of the iteration-0 check


def _jax_fog_boundary(size):
  """`scene/volumetric.fog_boundary_cornell`, staged with the JAX builder."""
  b = jcornell.build_cornell_box(film_size=size, diffuse_only=True, max_path_length=MPL,
                                 fog_scattering=pvol.FOG_SCATTERING, fog_g=pvol.FOG_G)
  scat = b.add_spectrum(jspec.SpectralDistribution.rgb_reflectance(pvol.CUBE_SCATTERING))
  absorb = b.add_spectrum(jspec.SpectralDistribution.rgb_reflectance(pvol.CUBE_ABSORPTION))
  inside = b.add_medium(JMediumDesc(name="cube", cls=1, scattering_spec=scat,
                                    absorption_spec=absorb, phase_g=pvol.CUBE_G))
  interface = b.add_material(JMaterialDesc(name="interface", cls=jtypes.MaterialClass.Boundary,
                                           int_medium=inside, ext_medium=b.camera_medium))
  jcornell._box(b, (0.3, 0.75, 0.3), (0.5, 0.5, 0.5), 25.0, interface)
  b.radiance_clamp = pvol.RADIANCE_CLAMP
  return b


def _builders(name, size=FILM, spectral=False):
  """(JAX builder, port builder) of a named scene of this slice."""
  if name == "volumetric":
    pair = (jscenes.volumetric(size), pvol.volumetric(size))
  elif name == "fog":
    pair = tuple(m.build_cornell_box(film_size=size, diffuse_only=True, max_path_length=MPL,
                                     fog_scattering=0.5, fog_g=0.4)
                 for m in (jcornell, pcornell))
  else:
    pair = (_jax_fog_boundary(size), pvol.fog_boundary_cornell(size))
  for b in pair:
    b.spectral = spectral
  return pair


@pytest.fixture(scope="module")
def cache_home(tmp_path_factory):
  """A per-user cache of the module's own for the cloud's `.vol` file."""
  home = tmp_path_factory.mktemp("cache")
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("XDG_CACHE_HOME", str(home))
    yield home


@pytest.fixture(scope="module")
def scenes(cache_home):
  """{(name, spectral): ((JAX scene, config), (port scene, config))}, the
  JAX tree built by its numpy builder."""
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    for key in (("volumetric", False), ("volumetric", True), ("fog_boundary", False),
                ("fog_boundary", True)):
      jb, pb = _builders(*key[:1], spectral=key[1])
      if key[0] == "volumetric":
        jb.max_path_length = pb.max_path_length = MPL
      out[key] = (jb.build(), pb.build(device="cpu"))
  return out


# ------------------------------------------------------------------- scene


def test_density_loader_matches_jax(cache_home, tmp_path):
  """The `.vol` file the volumetric scene writes loads back equal through
  both loaders; so does an `.npy` grid; a missing NanoVDB file gives None
  (`tests/test_torch_native.py` reads NanoVDB grids)."""
  path = pvol._cloud_vol_path()
  assert path.startswith(str(cache_home))
  got = ploader.load_density_grid(path)
  want = jloader._load_density_grid(path)
  assert got.shape == (24, 24, 24) and got.dtype == np.float32
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, pvol._expected_grid())
  npy = tmp_path / "grid.npy"
  np.save(npy, np.arange(24, dtype=np.float32).reshape(2, 3, 4))
  np.testing.assert_array_equal(ploader.load_density_grid(str(npy)),
                                jloader._load_density_grid(str(npy)))
  assert ploader.load_density_grid(str(tmp_path / "missing.vol")) is None
  assert ploader.load_density_grid(str(tmp_path / "cloud.nvdb")) is None
  assert jloader._load_density_grid(str(tmp_path / "cloud.nvdb")) is None


@pytest.mark.parametrize("name", ["volumetric", "fog", "fog_boundary"])
def test_media_tables_equal_jax(monkeypatch, cache_home, name):
  """The builders freeze equal tables field by field (the medium table, the
  materials' medium and subsurface columns, the camera's medium, the
  clamp) and equal configs; bench config 4 has no subsurface material."""
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
  jb, pb = _builders(name)
  arrays, config = pb.arrays()
  jscene, jconfig = jb.build()
  want = _jax_arrays(jscene)
  assert set(arrays) <= set(want)
  for key in arrays:
    got = np.asarray(arrays[key])
    assert got.dtype == want[key].dtype and got.shape == want[key].shape, key
    np.testing.assert_array_equal(got, want[key], err_msg=key)
  for f in dataclasses.fields(ptypes.SceneConfig):
    assert getattr(config, f.name) == getattr(jconfig, f.name), f.name
  assert config.has_media
  assert int(arrays["camera.medium_index"]) == 0
  if name == "volumetric":
    assert arrays["mediums.grid"].shape == (1, 24, 24, 24)
    assert arrays["mediums.grid"].max() == 1.0 and not config.has_subsurface
  if name == "fog_boundary":
    assert config.material_classes == (0, 7) and config.has_radiance_clamp
    assert float(arrays["radiance_clamp"]) == pvol.RADIANCE_CLAMP


def test_scene_bridge_gives_the_builders_media_scene(scenes):
  (jscene, jconfig), (want, want_config) = scenes[("fog_boundary", False)]
  scene, config = scene_bridge.from_numpy(_jax_arrays(jscene), dataclasses.asdict(jconfig),
                                          device="cpu")
  assert config == want_config
  for f in ptypes.DeviceScene._fields:
    got_t, want_t = getattr(scene, f), getattr(want, f)
    for g, w in zip(got_t if isinstance(got_t, tuple) else [got_t],
                    want_t if isinstance(want_t, tuple) else [want_t]):
      assert (g is None and w is None) or torch.equal(g, w), f


# ----------------------------------------------------------------- modules


def _unit(x):
  return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _close(got, want, what, rtol=MODULE_RTOL, atol=MODULE_ATOL):
  np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                             rtol=rtol, atol=atol, err_msg=what)


def test_phase_functions_match_jax():
  rng = np.random.default_rng(10)
  w_i = _unit(rng.normal(size=(LANES, 3)))
  w_o = _unit(rng.normal(size=(LANES, 3)))
  g = rng.uniform(-0.95, 0.95, LANES).astype(np.float32)
  g[:64] = 0.0           # isotropic
  g[64:128] = 5e-4       # below the isotropic threshold
  rnd = rng.uniform(size=(LANES, 2)).astype(np.float32)
  t = torch.from_numpy
  _close(pmedia.phase_hg(t(w_i), t(w_o), t(g)), jmedia.phase_hg(w_i, w_o, g), "phase_hg")
  _close(pmedia.sample_phase_hg(t(w_i), t(g), t(rnd)),
         jmedia.sample_phase_hg(jnp.asarray(w_i), jnp.asarray(g), jnp.asarray(rnd)),
         "sample_phase_hg", atol=1e-6)


@pytest.mark.parametrize("spectral", [False, True])
def test_sample_spectrum_component_matches_jax(spectral):
  rng = np.random.default_rng(11)
  c = 1 if spectral else 3
  albedo = rng.uniform(0.0, 1.0, (LANES, c)).astype(np.float32)
  albedo[:128] = 0.0     # the uniform pick
  thr = rng.uniform(0.0, 2.0, (LANES, c)).astype(np.float32)
  rnd = rng.uniform(size=LANES).astype(np.float32)
  ch, pdf = pmedia.sample_spectrum_component(torch.from_numpy(albedo), torch.from_numpy(thr),
                                             torch.from_numpy(rnd), spectral)
  jch, jpdf = jmedia.sample_spectrum_component(jnp.asarray(albedo), jnp.asarray(thr),
                                               jnp.asarray(rnd), spectral)
  np.testing.assert_array_equal(ch.numpy(), np.asarray(jch))
  _close(pdf, jpdf, "pdf")


def _medium_lanes(scene_pair, seed, spectral):
  """Seeded lanes in the room: medium rows (vacuum included), positions,
  directions, segment lengths, throughputs, wavelengths and RNG states."""
  (jscene, _), (pscene, _) = scene_pair
  rng = np.random.default_rng(seed)
  n_med = pscene.mediums.cls.shape[0]
  med = rng.integers(-1, n_med, LANES).astype(np.int32)
  pos = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (LANES, 3)).astype(np.float32)
  pos[:256] = rng.uniform(-1.5, 2.5, (256, 3))   # some outside the grid's box
  d = _unit(rng.normal(size=(LANES, 3)))
  d[:32] = [[1.0, 0.0, 0.0]] * 32                # axis-parallel
  dist = rng.uniform(0.01, 3.0, LANES).astype(np.float32)
  c = 1 if spectral else 3
  thr = rng.uniform(0.1, 1.5, (LANES, c)).astype(np.float32)
  wl = (rng.uniform(390.0, 770.0, LANES) if spectral else np.zeros(LANES)).astype(np.float32)
  state = rng.integers(0, 2 ** 32, LANES, dtype=np.uint64).astype(np.uint32)
  return med, pos, d, dist, thr, wl, state


def _views(scene_pair, med, wl, spectral):
  (jscene, _), (pscene, _) = scene_pair
  jmv = jmedia.gather_medium(jscene, jnp.asarray(med), jnp.asarray(wl), spectral)
  pmv = pmedia.gather_medium(pscene, torch.from_numpy(med), torch.from_numpy(wl), spectral)
  for f in pmedia.MediumView._fields:
    _close(getattr(pmv, f), getattr(jmv, f), f)
  return jmv, pmv


@pytest.mark.parametrize("spectral", [False, True])
def test_sample_density_matches_jax(scenes, spectral):
  """At grid points, inside cells, on the clamped edges and outside the
  box."""
  pair = scenes[("volumetric", spectral)]
  rng = np.random.default_rng(12)
  med = np.zeros(LANES, np.int32)
  _, pmv = _views(pair, med, np.zeros(LANES, np.float32), spectral)
  jmv = jmedia.gather_medium(pair[0][0], jnp.asarray(med), jnp.zeros(LANES), spectral)
  lo, hi = np.array([-1.0, 0.0, -1.0]), np.array([1.0, 2.0, 1.0])
  local = rng.uniform(0.0, 1.0, (LANES, 3))
  q = LANES // 4
  local[:q] = (rng.integers(0, 24, (q, 3)) + 0.5) / 24.0       # voxel centres
  local[q:q + q // 2] = rng.uniform(0.0, 0.5 / 24.0, (q // 2, 3))  # clamped low edge
  local[q + q // 2:2 * q] = rng.uniform(1.0 - 0.5 / 24.0, 1.0, (q // 2, 3))  # high edge
  local[2 * q:2 * q + q // 4] = rng.uniform(-0.3, 1.3, (q // 4, 3))  # in and out
  pts = (lo + local * (hi - lo)).astype(np.float32)
  got = pmedia.sample_density(pair[1][0], pmv, torch.from_numpy(pts))
  want = jmedia.sample_density(pair[0][0], jmv, jnp.asarray(pts))
  _close(got, want, "density")
  assert (got.numpy() == 0.0).sum() > 0 and got.numpy().max() > 0.5


@pytest.mark.parametrize("name,spectral", [("volumetric", False), ("volumetric", True),
                                           ("fog_boundary", False), ("fog_boundary", True)])
def test_sample_medium_and_transmittance_match_jax(scenes, name, spectral):
  """Free-path sampling and transmittance over seeded lanes: outputs within
  SAMPLE_RTOL, RNG states equal (the delta- and ratio-tracking loops ran
  the same number of times)."""
  pair = scenes[(name, spectral)]
  (jscene, _), (pscene, _) = pair
  med, pos, d, dist, thr, wl, state = _medium_lanes(pair, 13, spectral)
  jmv, pmv = _views(pair, med, wl, spectral)
  t = torch.from_numpy
  got, gstate = pmedia.sample_medium(pscene, pmv, t(wl), t(thr),
                                     t(state.astype(np.int64)), t(pos), t(d), t(dist), spectral)
  want, wstate = jmedia.sample_medium(jscene, jmv, jnp.asarray(wl), jnp.asarray(thr),
                                      jnp.asarray(state), jnp.asarray(pos), jnp.asarray(d),
                                      jnp.asarray(dist), spectral)
  np.testing.assert_array_equal(gstate.numpy().astype(np.uint32), np.asarray(wstate))
  np.testing.assert_array_equal(got.sampled.numpy(), np.asarray(want.sampled))
  for f in ("t", "pos", "weight"):
    _close(getattr(got, f), getattr(want, f), f, SAMPLE_RTOL, SAMPLE_ATOL)
  assert got.sampled.any() and not got.sampled.all()

  gtr, gstate = pmedia.transmittance(pscene, pmv, t(wl), t(state.astype(np.int64)), t(pos),
                                     t(d), t(dist), spectral)
  wtr, wstate = jmedia.transmittance(jscene, jmv, jnp.asarray(wl), jnp.asarray(state),
                                     jnp.asarray(pos), jnp.asarray(d), jnp.asarray(dist),
                                     spectral)
  np.testing.assert_array_equal(gstate.numpy().astype(np.uint32), np.asarray(wstate))
  _close(gtr, wtr, "transmittance", SAMPLE_RTOL, SAMPLE_ATOL)
  assert (gtr.numpy() < 1.0).any()


# --------------------------------------------------------------- main path


@pytest.mark.parametrize("name", ["volumetric", "fog_boundary"])
def test_pt_step_without_deferred_nee_matches_jax(scenes, name):
  """Two bounces of the non-deferred step from the same 1024 lanes:
  medium events, NEE through `_trace_transmittance` (and, in the
  fog_boundary scene, Boundary pass-through into the cube's medium)."""
  (jscene, jconfig), (pscene, pconfig) = scenes[(name, False)]
  assert not ppt.uses_deferred_nee(pconfig)
  ids = np.arange(1024) + 1024
  jst = jpt.make_lane_payload(jscene, jconfig, jnp.asarray(ids, jnp.int32), jnp.int32(2 ** 30))
  pst = ppt.make_lane_payload(pscene, pconfig, torch.from_numpy(ids), 2 ** 30)
  np.testing.assert_array_equal(pst.medium.numpy(), np.asarray(jst.medium))
  for step in range(2):
    jst = jpt.pt_step(jscene, jconfig, jst, deferred_nee=False)
    pst = ppt.pt_step(pscene, pconfig, pst)
    same = np.asarray(jst.alive) == pst.alive.numpy()
    assert same.mean() >= 0.99, f"step {step}"
    np.testing.assert_array_equal(pst.rng_state.numpy()[same].astype(np.uint32),
                                  np.asarray(jst.rng_state)[same])
    np.testing.assert_array_equal(pst.medium.numpy()[same], np.asarray(jst.medium)[same])
    for f in ("ray_o", "ray_d", "throughput", "accumulated", "view_normal", "view_albedo",
              "bsdf_pdf"):
      g = getattr(pst, f).numpy()[same]
      w = np.asarray(getattr(jst, f))[same]
      close = np.isclose(g, w, rtol=1e-4, atol=1e-4)
      assert close.reshape(close.shape[0], -1).all(axis=1).mean() >= 0.99, (step, f)
    assert (pst.psh_tmax.numpy() < 0).all() and not pst.res_valid.any()
    assert float(pst.rays_traced) == pytest.approx(float(jst.rays_traced), rel=0.01)
  assert (pst.accumulated.numpy() > 0).any()


def test_iteration_zero_parts_from_jax_only_through_the_corner_rays(scenes):
  """Why the renders start at iteration 1. On the lanes of iteration 0
  (pixel centres), the two packages' camera rays leave the same origins in
  directions an ulp apart, and their closest hits differ only on lanes of
  the film's diagonals, whose rays meet a room corner edge. From its own rays the port's RNG states part from the
  JAX package's within STEPS bounces (a loop's trip count changed over the
  wavefront); given the JAX package's camera rays, they stay equal on
  every lane for all STEPS bounces."""
  (jscene, jconfig), (pscene, pconfig) = scenes[("volumetric", False)]
  ids = np.arange(FILM[0] * FILM[1])
  jst0 = jpt.make_lane_payload(jscene, jconfig, jnp.asarray(ids, jnp.int32), jnp.int32(2 ** 30))
  pst0 = ppt.make_lane_payload(pscene, pconfig, torch.from_numpy(ids), 2 ** 30)
  np.testing.assert_array_equal(pst0.ray_o.numpy(), np.asarray(jst0.ray_o))
  jd = np.asarray(jst0.ray_d)
  np.testing.assert_allclose(pst0.ray_d.numpy(), jd, rtol=2e-7, atol=1e-7)
  jhit = jtrace.trace_closest(jscene, jst0.ray_o, jst0.ray_d, jst0.t_min, jst0.t_max)
  hit = brute_trace.intersect_plain(*pscene[:3], pst0.ray_o, pst0.ray_d, pst0.t_min, pst0.t_max)
  differ = np.nonzero(hit.tri.numpy() != np.asarray(jhit.tri))[0]
  px, py = differ % FILM[0], differ // FILM[0]
  assert differ.shape[0] > 0
  assert ((px == py) | (px + py == FILM[0] - 1)).all(), differ

  # the JAX package's states after each bounce, stepped once for both checks
  jstates = [jst0]

  def parted(pst):
    for step in range(STEPS):
      if len(jstates) == step + 1:
        jstates.append(jpt.pt_step(jscene, jconfig, jstates[step], deferred_nee=False))
      pst = ppt.pt_step(pscene, pconfig, pst)
      want = np.asarray(jstates[step + 1].rng_state)
      if (pst.rng_state.numpy().astype(np.uint32) != want).any():
        return True
    return False

  assert parted(pst0)
  assert not parted(pst0._replace(ray_d=torch.from_numpy(jd.copy())))


def _renders(pair):
  (jscene, jconfig), (pscene, pconfig) = pair
  sums, rays = jpt.render_samples_static(jscene, jconfig, FIRST, SPP, pool_size=POOL)
  fs = jpt.finalize_film(sums, SPP, jconfig.film_width)
  jimg = np.asarray(fs.camera + fs.light)
  before = dict(brute_trace.launches)
  psums, prays = ppt.render_samples_static(pscene, pconfig, FIRST, SPP, pool_size=POOL,
                                           device="cpu")
  assert brute_trace.launches == before  # the plain versions on the CPU
  img = pfilm.result_image(ppt.finalize_film(psums, SPP, pconfig.film_width)).numpy()
  return img, jimg, psums.table.numpy(), np.asarray(sums.table), int(prays), float(rays)


@pytest.mark.parametrize("name", ["volumetric", "fog_boundary"])
def test_media_render_matches_jax_pixel_by_pixel(scenes, name):
  img, ref, table, ref_table, rays, ref_rays = _renders(scenes[(name, False)])
  assert img.shape == ref.shape == (FILM[1], FILM[0], 3)
  assert np.isfinite(img).all() and (img >= 0.0).all()
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.mean() <= OUTLIER_FRACTION, outliers.mean()
  assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())
  np.testing.assert_array_equal(table[:, 12], np.full(FILM[0] * FILM[1], SPP))
  np.testing.assert_array_equal(table[:, 12], ref_table[:, 12])
  assert rays == pytest.approx(ref_rays, rel=0.01)
  if name == "volumetric":  # (the cube's orange medium fills the other's right third)
    third = FILM[0] // 3
    left, right = img[:, :third].mean((0, 1)), img[:, -third:].mean((0, 1))
    assert left[0] > left[1] and right[1] > right[0]
