"""The port's subsurface scattering against the JAX package (CPU).

The configuration of the JAX package's `tests/test_media.py::test_sss_render`
(the diffuse Cornell box with its gray material made subsurface, mean free
paths rgb 0.3, 0.1, 0.05; `scene/volumetric.subsurface_cornell`), random
walk and Christensen-Burley. The modules: the Burley remap and profile,
`trace_material` (closest hit on one material, stepping past the others),
the random-walk and Christensen-Burley gathers and their dispatch, and the
whole render.

Both packages get the same inputs, made from numpy seeds; the JAX side runs
eagerly. Module outputs agree within MODULE_RTOL relative (MODULE_ATOL
absolute near zero); `found` and the exit triangles are equal, and so are
the RNG states the gathers return: the walk's and the skips' loops run over
the whole wavefront for the same trip counts. The renders are held to the
JAX package's jitted render pixel by pixel at tests/test_torch_render.py's
tolerances, from iteration 1 (tests/test_torch_media.py says why not 0).

A walk is not reproduced lane for lane by the jitted JAX code. The boxes'
bottom faces lie in the floor's plane, so every walk or probe that leaves a
box downwards meets two triangles at a tie, which the port's closest hit
gives to the lower index, as its kernel K1 does, while XLA fuses
multiply-adds in the jitted scan and moves one t by an ulp either way
(test_coplanar_ties_are_the_only_difference); and the fused multiply-adds
and the last-ulp differences of XLA's and PyTorch's exp and log move the
walk's positions. Measured on the 1,024 seeded lanes of test_gathers_match_jax
(a lane agrees when `found` and the exit triangle are equal): the
Christensen-Burley gather agrees with the JAX code run op by op
(`jax.disable_jit`) on 99.9% of the lanes, with every weight within
MODULE_RTOL, while the JAX code jitted agrees with itself op by op on 99.6%,
only 95.1% of weights within MODULE_RTOL; the random walk agrees with the
jitted JAX code on 97.4% of the lanes, and the JAX code jitted with itself op
by op on 97.3%. So the Christensen-Burley gather is held to the op-by-op JAX
code (LANE_FLIP_OP), the random walk, which takes over a minute op by op, to
the jitted one (LANE_FLIP).

In the bounce (test_pt_step_with_subsurface_matches_jax, two steps) every lane's RNG state stays equal to the
JAX package's; what differs is a lane's weight where one probe or walk
step meets such a tie: the same exit, another sum of candidate weights
(Christensen-Burley, throughput within 1e-4 on 97.9% and 97.1% of the
lanes after the two steps, 98.4% and 97.9% against the JAX code run op by
op; random walk 99.6% and 98.8%). Those lanes carry into the renders, each
held to the jitted JAX render at limits set just above its readings (16x16,
2 spp from iteration 1): the random walk, 0.4% outlier pixels and 0.74% on
the mean, to RW_OUTLIER_FRACTION and RW_MEAN_RTOL; Christensen-Burley, 6.25%
and 0.50%, to CB_OUTLIER_FRACTION and CB_MEAN_RTOL. The op-by-op JAX render
of Christensen-Burley is no closer (5.1% outlier pixels, 0.15% on the mean)
and takes over three minutes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.core import spectrum as jspec
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.ops import gather as jgather
from etx_tracer_tpu.ops import trace as jtrace
from etx_tracer_tpu.render import subsurface as jsss
from etx_tracer_tpu.render.bsdf import lobes as jlobes
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.scene import packed as jpacked
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.ops import brute_trace
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.render import subsurface as psss
from etx_tracer_tpu_torch.render.bsdf import lobes as plobes
from etx_tracer_tpu_torch.scene import packed as ppacked
from etx_tracer_tpu_torch.scene import types as ptypes
from etx_tracer_tpu_torch.scene import volumetric as pvol
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FILM, SPP, MPL, POOL, FIRST = (16, 16), 2, 6, 256, 1  # the whole-render comparisons
MODULE_RTOL = 1e-5
MODULE_ATOL = 1e-6
LANE_FLIP = 0.04              # lanes whose walk may end elsewhere, jitted JAX (see above)
LANE_FLIP_OP = 0.005          # ... against the JAX code run op by op
# whole renders (see above): pixels off by > 1e-4 + 1e-3 |ref|, image mean
RW_OUTLIER_FRACTION, RW_MEAN_RTOL = 0.02, 0.008
CB_OUTLIER_FRACTION, CB_MEAN_RTOL = 0.07, 0.006
LANES = 1024
RW, CB = ptypes.SubsurfaceClass.RandomWalk, ptypes.SubsurfaceClass.ChristensenBurley


def _jax_subsurface(size, cls, spectral=False):
  """`scene/volumetric.subsurface_cornell`, staged with the JAX builder."""
  import dataclasses
  b = jcornell.build_cornell_box(film_size=size, diffuse_only=True, max_path_length=MPL)
  gi = b.material_names["gray"]
  dist = b.add_spectrum(jspec.SpectralDistribution.rgb_reflectance([0.3, 0.1, 0.05]))
  b.materials[gi] = dataclasses.replace(b.materials[gi], subsurface_cls=cls,
                                        subsurface_spec=dist)
  b.spectral = spectral
  return b


@pytest.fixture(scope="module")
def scenes():
  """{(class, spectral): ((JAX scene, config), (port scene, config))}, the
  JAX tree built by its numpy builder."""
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    for cls, spectral in ((RW, False), (RW, True), (CB, False)):
      pb = pvol.subsurface_cornell(FILM, cls)
      pb.spectral = spectral
      out[(cls, spectral)] = (_jax_subsurface(FILM, cls, spectral).build(),
                              pb.build(device="cpu"))
  return out


def _close(got, want, what, rtol=MODULE_RTOL, atol=MODULE_ATOL):
  np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                             rtol=rtol, atol=atol, err_msg=what)


def _unit(x):
  return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# ----------------------------------------------------------------- modules


def test_remap_and_profile_match_jax():
  rng = np.random.default_rng(20)
  color = rng.uniform(0.0, 1.2, (LANES, 3)).astype(np.float32)
  color[:16] = 0.0
  dist = rng.uniform(0.0, 0.5, (LANES, 3)).astype(np.float32)
  dist[16:32] = 0.0          # below the remap's floor
  t = torch.from_numpy
  for g, w, what in zip(psss.remap(t(color), t(dist)),
                        jsss.remap(jnp.asarray(color), jnp.asarray(dist)),
                        ("albedo", "extinction", "scattering")):
    _close(g, w, what)
  rnd = rng.uniform(size=LANES).astype(np.float32)
  rnd[:4] = [0.0, 0.2499999, 0.25, 1.0 - 2 ** -24]
  _close(psss._sample_s_r(t(rnd)), jsss._sample_s_r(jnp.asarray(rnd)), "sample_s_r")
  radius = rng.uniform(0.0, 2.0, LANES).astype(np.float32)
  _close(psss._cb_profile(t(dist), t(radius)),
         jsss._cb_profile(jnp.asarray(dist), jnp.asarray(radius)), "cb_profile")


def test_coplanar_ties_are_the_only_difference(scenes):
  """The JAX package's jitted closest hit and the port's plain one, on rays
  from inside the room and rays down from inside the boxes: where they
  pick other triangles, the port's arithmetic puts the JAX package's pick
  at the port's t or at most 2 ulps beyond it (a tie, or one that fused
  multiply-adds reorder), never nearer."""
  (jscene, _), (pscene, _) = scenes[(RW, False)]
  rng = np.random.default_rng(23)
  o = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (LANES, 3)).astype(np.float32)
  o[: LANES // 2] = rng.uniform([0.1, 0.05, 0.15], [0.55, 0.55, 0.6], (LANES // 2, 3))
  d = _unit(rng.normal(size=(LANES, 3)))
  d[: LANES // 2, 1] = -np.abs(d[: LANES // 2, 1])
  t_min = np.full(LANES, 1e-4, np.float32)
  t_max = np.full(LANES, 1e30, np.float32)
  want = jax.jit(jtrace.trace_closest)(jscene, *(jnp.asarray(x) for x in (o, d, t_min, t_max)))
  t = torch.from_numpy
  got = brute_trace.intersect_plain(*pscene[:3], t(o), t(d), t(t_min), t(t_max))
  jtri = np.asarray(want.tri)
  differ = np.nonzero(got.tri.numpy() != jtri)[0]
  assert 0 < differ.shape[0] <= LANES // 20, differ.shape[0]
  for i in differ:
    k = int(jtri[i])
    alone = brute_trace.intersect_plain(*(x[k:k + 1] for x in pscene[:3]), t(o[i:i + 1]),
                                        t(d[i:i + 1]), t(t_min[i:i + 1]), t(t_max[i:i + 1]))
    near = got.t[i:i + 1]
    two_ulps = torch.nextafter(torch.nextafter(near, near + 1), near + 1)
    assert int(alone.tri) == 0 and near <= alone.t <= two_ulps, (i, alone, near)


def test_trace_material_matches_jax(scenes):
  """Rays from inside the room to a target material: hits on the others
  are stepped past (at most 4 traces), as in the JAX package."""
  (jscene, _), (pscene, _) = scenes[(RW, False)]
  rng = np.random.default_rng(21)
  o = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (LANES, 3)).astype(np.float32)
  d = _unit(rng.normal(size=(LANES, 3)))
  t_max = rng.uniform(0.5, 5.0, LANES).astype(np.float32)
  t_max[:64] = 0.0                                   # done lanes trace nothing
  target = rng.integers(0, 5, LANES).astype(np.int32)
  t_min = np.full(LANES, 1e-4, np.float32)
  t = torch.from_numpy
  got = psss.trace_material(pscene, t(o), t(d), t(t_min), t(t_max), t(target))
  want = jsss.trace_material(jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
                             jnp.asarray(t_max), jnp.asarray(target))
  found = got[0].numpy()
  same = (found == np.asarray(want[0])) & (got[4].numpy() == np.asarray(want[4]))
  assert same.mean() >= 1.0 - LANE_FLIP, same.mean()
  assert 0.1 < found.mean() < 0.9 and not found[:64].any()
  both = same & found
  for g, w, what in zip(got[1:4], want[1:4], ("t", "u", "v")):
    _close(g.numpy()[both], np.asarray(w)[both], what)


def _entry_lanes(pair, seed, spectral):
  """Seeded entry points on the gray (subsurface) triangles that a path can
  reach (not the boxes' bottom faces, which lie on the floor): (JAX
  ShadingData, port ShadingData, material rows, positions, RNG states,
  active lanes)."""
  (jscene, _), (pscene, _) = pair
  rng = np.random.default_rng(seed)
  tri_table = pscene.tri_table.numpy()
  gray = np.nonzero((tri_table[:, 3] == 1) & (tri_table[:, 1] > -0.5))[0]
  tri = gray[rng.integers(0, gray.shape[0], LANES)]
  u = rng.uniform(0.0, 1.0, LANES).astype(np.float32)
  v = (rng.uniform(0.0, 1.0, LANES) * (1.0 - u)).astype(np.float32)
  pos = (pscene.tri_v0.numpy()[tri] + u[:, None] * pscene.tri_e1.numpy()[tri]
         + v[:, None] * pscene.tri_e2.numpy()[tri]).astype(np.float32)
  rows = tri_table[tri]
  w0, w1, w2 = (1.0 - u - v)[:, None], u[:, None], v[:, None]
  nrm = _unit(rows[:, 6:9] * w0 + rows[:, 9:12] * w1 + rows[:, 12:15] * w2)
  tan = _unit(rows[:, 15:18] * w0 + rows[:, 18:21] * w1 + rows[:, 21:24] * w2)
  btn = _unit(np.cross(nrm, tan))
  geo_n = rows[:, 0:3].astype(np.float32)
  w_i = _unit(rng.normal(size=(LANES, 3)))
  w_i = np.where((np.sum(w_i * nrm, -1) > 0)[:, None], -w_i, w_i).astype(np.float32)
  wl = (rng.uniform(390.0, 770.0, LANES) if spectral else np.zeros(LANES)).astype(np.float32)
  mat_idx = rows[:, 3].astype(np.int32)
  state = rng.integers(0, 2 ** 32, LANES, dtype=np.uint64).astype(np.uint32)
  active = rng.uniform(size=LANES) < 0.75
  jmat = jpacked.unpack_material_rows(jgather.take_rows(jscene.mat_table, jnp.asarray(mat_idx)))
  jsd = jlobes.ShadingData(w_i=jnp.asarray(w_i), nrm=jnp.asarray(nrm), tan=jnp.asarray(tan),
                           btn=jnp.asarray(btn), geo_n=jnp.asarray(geo_n),
                           tex=jnp.zeros((LANES, 2)), wl=jnp.asarray(wl),
                           medium=jnp.full(LANES, -1, jnp.int32), mat=jmat)
  t = torch.from_numpy
  psd = plobes.ShadingData(w_i=t(w_i), nrm=t(nrm), tan=t(tan), btn=t(btn), geo_n=t(geo_n),
                           tex=torch.zeros((LANES, 2)), wl=t(wl),
                           medium=torch.full((LANES,), -1, dtype=torch.int32),
                           mat=ppacked.MaterialRows(pscene.mat_table[t(mat_idx).long()]))
  return jsd, psd, mat_idx, pos, state, active


@pytest.mark.parametrize("kind,spectral,classes", [
    ("rw", False, (RW,)), ("rw", True, (RW,)), ("cb", False, (CB,)), ("cb", True, (CB,)),
    ("gather", False, (RW, CB))])
def test_gathers_match_jax(scenes, kind, spectral, classes):
  """The random-walk and Christensen-Burley gathers, and the dispatch with
  both classes listed (every gray lane is random walk here, so the
  Christensen-Burley gather runs with no active lane), on seeded entry
  lanes: RNG states equal; `found` and the exit triangle equal on all but
  a share of the lanes, exits and weights within MODULE_RTOL on all but that
  share of the others: LANE_FLIP against the jitted JAX code for the random
  walk and the dispatch, LANE_FLIP_OP against the JAX code run op by op for
  Christensen-Burley."""
  pair = scenes[(RW, spectral)]
  (jscene, _), (pscene, _) = pair
  jsd, psd, mat_idx, pos, state, active = _entry_lanes(pair, 22, spectral)
  t = torch.from_numpy
  jargs = (jscene, jsd, jnp.asarray(mat_idx), jnp.asarray(pos), jnp.asarray(state),
           jnp.asarray(active), spectral)
  pargs = (pscene, psd, t(mat_idx), t(pos), t(state.astype(np.int64)), t(active), spectral)
  if kind == "rw":
    (want, wstate), (got, gstate) = jsss.gather_rw(*jargs), psss.gather_rw(*pargs)
  elif kind == "cb":
    with jax.disable_jit():
      want, wstate = jsss.gather_cb(*jargs)
    got, gstate = psss.gather_cb(*pargs)
  else:
    want, wstate = jsss.gather(*jargs, subsurface_classes=classes)
    got, gstate = psss.gather(*pargs, subsurface_classes=classes)
  np.testing.assert_array_equal(gstate.numpy().astype(np.uint32), np.asarray(wstate))
  flip = LANE_FLIP_OP if kind == "cb" else LANE_FLIP
  found = got.found.numpy()
  same = (found == np.asarray(want.found)) & (~found | (got.tri.numpy() == np.asarray(want.tri)))
  assert same.mean() >= 1.0 - flip, same.mean()
  assert 0.2 < found.mean() <= 0.75 and not found[~active].any()
  both = same & found
  for f in ("pos", "nrm", "geo_n", "tan", "btn", "uv", "weight", "w_i"):
    g, w = getattr(got, f).numpy()[both], np.asarray(getattr(want, f))[both]
    close = np.isclose(g, w, rtol=MODULE_RTOL, atol=MODULE_ATOL).all(axis=-1)
    assert close.mean() >= 1.0 - flip, (f, close.mean())


# --------------------------------------------------------------- main path


@pytest.mark.parametrize("cls", [RW, CB])
def test_pt_step_with_subsurface_matches_jax(scenes, cls):
  """Two bounces with deferred NEE from the same LANES lanes, from the
  render's first iteration on, a quarter or more of them entering the subsurface material
  first: RNG states equal on every lane; the exit's continuation, the
  throughput (times the gather's weight) and the exit's NEE (the pending
  shadow ray, white diffuse times the weight) within 1e-4 on all but
  LANE_FLIP of the lanes."""
  (jscene, jconfig), (pscene, pconfig) = scenes[(cls, False)]
  ids = np.arange(LANES) + FILM[0] * FILM[1]
  jst = jpt.make_lane_payload(jscene, jconfig, jnp.asarray(ids, jnp.int32), jnp.int32(2 ** 30))
  pst = ppt.make_lane_payload(pscene, pconfig, torch.from_numpy(ids), 2 ** 30)
  first = brute_trace.intersect_plain(*pscene[:3], pst.ray_o, pst.ray_d, pst.t_min, pst.t_max)
  gray = pscene.tri_table[first.tri.clamp(min=0).long(), 3] == 1
  assert ((first.tri >= 0) & gray).float().mean() >= 0.25
  for step in range(2):
    jst = jpt.pt_step(jscene, jconfig, jst, deferred_nee=True)
    pst = ppt.pt_step(pscene, pconfig, pst)
    np.testing.assert_array_equal(pst.rng_state.numpy().astype(np.uint32),
                                  np.asarray(jst.rng_state))
    same = ((np.asarray(jst.alive) == pst.alive.numpy())
            & (np.asarray(jst.res_valid) == pst.res_valid.numpy()))
    assert same.mean() >= 0.99, f"step {step}"
    for name in ("ray_o", "ray_d", "throughput", "accumulated", "bsdf_pdf", "psh_o", "psh_d",
                 "psh_tmax", "psh_rgb", "res_rgb"):
      g = getattr(pst, name).numpy()[same]
      w = np.asarray(getattr(jst, name))[same]
      close = np.isclose(g, w, rtol=1e-4, atol=1e-4)
      assert close.reshape(close.shape[0], -1).all(axis=1).mean() >= 1.0 - LANE_FLIP, (step, name)


@pytest.mark.parametrize("cls", [RW, CB])
def test_subsurface_render_matches_jax_pixel_by_pixel(scenes, cls):
  (jscene, jconfig), (pscene, pconfig) = scenes[(cls, False)]
  assert pconfig.has_subsurface and pconfig.subsurface_classes == (cls,)
  assert ppt.uses_deferred_nee(pconfig)
  sums, rays = jpt.render_samples_static(jscene, jconfig, FIRST, SPP, pool_size=POOL)
  fs = jpt.finalize_film(sums, SPP, jconfig.film_width)
  ref = np.asarray(fs.camera + fs.light)
  psums, prays = ppt.render_samples_static(pscene, pconfig, FIRST, SPP, pool_size=POOL,
                                           device="cpu")
  img = pfilm.result_image(ppt.finalize_film(psums, SPP, pconfig.film_width)).numpy()
  assert img.shape == ref.shape == (FILM[1], FILM[0], 3)
  assert np.isfinite(img).all() and (img >= 0.0).all()
  outlier_fraction, mean_rtol = ((RW_OUTLIER_FRACTION, RW_MEAN_RTOL) if cls == RW
                                 else (CB_OUTLIER_FRACTION, CB_MEAN_RTOL))
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.mean() <= outlier_fraction, outliers.mean()
  assert abs(img.mean() - ref.mean()) <= mean_rtol * abs(ref.mean()), (img.mean(), ref.mean())
  np.testing.assert_array_equal(psums.table.numpy()[:, 12], np.full(FILM[0] * FILM[1], SPP))
  assert int(prays) == pytest.approx(float(rays), rel=0.01)
  third = FILM[0] // 3
  left, right = img[:, :third].mean((0, 1)), img[:, -third:].mean((0, 1))
  assert left[0] > left[1] and right[1] > right[0]
