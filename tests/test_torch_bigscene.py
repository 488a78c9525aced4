"""The port's bigscene slice against the JAX package (CPU).

Bigscene (`benchmarks/scenes.py:bigscene`: twelve order-3 icospheres in the
diffuse Cornell box, 15,396 triangles) is the first scene above the
pair-tile kernels' 4096 triangles, so it brings the BVH side of tracing:

- the numpy BVH builder (`etx_tracer_tpu_torch/ops/bvh_build.py`), whose
  arrays must equal the JAX package's numpy builder's, with the JAX package's
  native C++ builder turned off (monkeypatched) so that it builds with numpy;
- the plain versions of the BVH kernels K5-K8 (`ops/bvh_trace.py`), held
  against the TPU kernels' own bodies (`pallas_trace.intersect_bvh_fat_pallas`,
  `occluded_bvh_fat_pallas`, `intersect_bvh_pallas`, `occluded_bvh_pallas`)
  run in interpret mode, and against the JAX package's CPU route
  (`trace.trace_closest` / `trace_occluded`, its per-ray-stack
  `intersect_bvh`) on bigscene;
- the scene itself and the whole render, pixel by pixel, against the JAX
  package's render through the route it takes on its device for this scene,
  the TPU kernels K5/K6 (`intersect_bvh_fat_pallas`, `occluded_bvh_fat_pallas`),
  run in interpret mode.

The JAX references run jitted, where XLA contracts products and sums into
fused multiply-adds while the port rounds each operation, so hit distances
agree to a relative T_RTOL, and `tri` is compared exactly wherever the ray's
two nearest hits are not tied and no edge or interval end is grazed. The
JAX package's CPU route walks the right child first, so where two hits tie
exactly (coplanar triangles of the room's quads) it may keep another
triangle than the port's left-first walk; its default tree may also come
from its native builder, whose tree differs in every array. Such ties are
common in a render: at iteration 0 the pixel-centre rays of the film's
diagonals hit the room's corner lines, where a floor and a wall triangle
give the same t and the tie's winner sets the pixel's colour. So the whole
render is held against the JAX render through K5/K6, which keep the first
of equal hits in the same pre-order as the port.
"""

import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks import scenes as jscenes
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.ops import bvh_build as jbvh_build
from etx_tracer_tpu.ops import pallas_trace as jpallas
from etx_tracer_tpu.ops import trace as jtrace
from etx_tracer_tpu.scene import types as jtypes
from etx_tracer_tpu_torch import scene_bridge
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.ops import brute2_trace, brute_trace, bvh_build, bvh_trace, woop_trace
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.scene import bigscene, materials
from etx_tracer_tpu_torch.scene import types as ptypes
from tests.test_torch_render import assert_bvh_holds_tree
from tests.test_torch_trace import T_ATOL, T_RTOL, UV_ATOL, _all_hits_at, _rays, _tris
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FILM, SPP, POOL = (16, 16), 2, 256   # the whole-render comparison
OUTLIER_FRACTION = 0.02              # whole render: pixels off by > 1e-4 + 1e-3 |ref|
MEAN_RTOL = 0.005                    # whole render: image mean
ROOM = (np.float32([-0.9, 0.1, -0.9]), np.float32([0.9, 1.9, 0.9]))  # ray origins


def _numpy_tree(monkeypatch):
  """Turn the JAX package's native BVH builder off: it builds with numpy."""
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)


def _jax_arrays(scene):
  """The JAX DeviceScene's leaves as numpy arrays keyed by dotted field path
  (the per-step cache aside; fat_rows only when set)."""
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


@pytest.fixture(scope="module")
def jax_scene():
  """The JAX package's 16x16 bigscene, its tree built by its numpy builder."""
  with pytest.MonkeyPatch.context() as mp:
    _numpy_tree(mp)
    return jscenes.bigscene(FILM).build()


@pytest.fixture(scope="module")
def port_scene():
  return bigscene.build_bigscene(FILM).build(device="cpu")


@pytest.fixture(scope="module")
def port_arrays():
  """The port builder's bigscene tables and config (`SceneBuilder.arrays`)."""
  return bigscene.build_bigscene(FILM).arrays()


def _torch(*xs):
  return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _port_bvh(v0, e1, e2):
  tree = bvh_build.build_bvh(v0, e1, e2)
  arrays = {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
            **{f"bvh.{k}": v for k, v in tree.items()}}
  return ptypes.bvh_from_arrays(bvh_build.kernel_tables(arrays), "cpu")


def _jax_bvh(v0, e1, e2):
  tree = jbvh_build.build_bvh(v0, e1, e2)
  return jtypes.BVH(**{k: None if v is None else jnp.asarray(v) for k, v in tree.items()})


def _near_tie(hits):
  srt = np.sort(hits, axis=1)
  with np.errstate(invalid="ignore"):
    return np.isfinite(srt[:, 1]) & (srt[:, 1] - srt[:, 0] <= 1e-4 * np.maximum(1.0, srt[:, 0]))


def _ties_and_grazing(v0, e1, e2, o, d, t_min, t_max, mask, step=128):
  """(near_tie, grazing) per ray, as tests/test_torch_trace.py defines them,
  over chunks of rays (bigscene's 15,396 triangles would not fit at once)."""
  ties, graze = [], []
  for r0 in range(0, o.shape[0], step):
    sl = slice(r0, r0 + step)
    args = (v0, e1, e2, o[sl], d[sl], t_min[sl], t_max[sl], mask)
    hits, loose, strict = _all_hits_at(*args, (1e-6, 1e-5, -1e-5))
    ties.append(_near_tie(hits))
    graze.append((np.isfinite(loose) != np.isfinite(strict)).any(axis=1))
  return np.concatenate(ties), np.concatenate(graze)


def _room_rays(rng, v0, e2, n):
  o, d, t_min, t_max = _rays(rng, v0, e2, n)
  lo, hi = ROOM
  o = (lo + (o + 2.0) / 4.0 * (hi - lo)).astype(np.float32)  # inside the room
  return o, d, t_min, t_max


# ------------------------------------------------------------------ builder


@pytest.mark.parametrize("which", ["soup", "bigscene"])
def test_bvh_build_equals_jax_numpy_builder(monkeypatch, request, which):
  if which == "soup":
    v0, e1, e2 = _tris(np.random.default_rng(30), 3000)
  else:
    arrays, _ = request.getfixturevalue("port_arrays")
    v0, e1, e2 = (arrays[k] for k in ("tri_v0", "tri_e1", "tri_e2"))
    assert v0.shape == (bigscene.NUM_TRIANGLES, 3)
  _numpy_tree(monkeypatch)
  want = jbvh_build.build_bvh(v0, e1, e2)
  got = bvh_build.build_bvh(v0, e1, e2)
  assert set(got) == set(want)
  for name in want:
    assert want[name] is not None, name
    assert got[name].dtype == want[name].dtype, name
    np.testing.assert_array_equal(got[name], want[name], err_msg=name)
  if which == "bigscene":
    assert got["node_min"].shape == (9545, 3) and got["fat_rows"].shape == (4772, 16)
    assert bvh_build.tree_depth(got["node_left"], got["node_count"]) <= bvh_build.STACK_DEPTH


@pytest.mark.parametrize("case", ["root_leaf", "leaf_of_32"])
def test_build_fat_rows_has_no_fat_form_as_jax(case):
  """A root leaf, and a leaf of 32 or more triangles (the count packing's
  5 bits), give no fat rows in both packages."""
  if case == "root_leaf":
    node_min, node_max = np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32)
    node_left, node_count = np.zeros(1, np.int32), np.full(1, 3, np.int32)
  else:
    node_min, node_max = np.zeros((3, 3), np.float32), np.ones((3, 3), np.float32)
    node_left = np.asarray([2, 0, 32], np.int32)
    node_count = np.asarray([0, 32, 4], np.int32)
  args = (node_min, node_max, node_left, node_count)
  assert jbvh_build.build_fat_rows(*args) is None
  assert bvh_build.build_fat_rows(*args) is None
  np.testing.assert_array_equal(bvh_build.compute_skip(node_left, node_count),
                                jbvh_build.compute_skip(node_left, node_count))


def test_bvh_deeper_than_the_kernels_stack_raises():
  """A chain of 70 inner nodes: deeper than the 64-entry traversal stack."""
  depth = bvh_build.STACK_DEPTH + 6
  n = 2 * depth + 1
  node_left = np.zeros(n, np.int32)
  node_count = np.zeros(n, np.int32)
  for k in range(depth):        # inner node k: left child k+1, right child a leaf
    node_left[k] = n - 1 - k
  node_count[depth:] = 1
  assert bvh_build.tree_depth(node_left, node_count) == depth
  with pytest.raises(ValueError, match="traversal stack"):
    bvh_build.check_depth(node_left, node_count)


def test_icosphere_order3_equals_the_jax_bench_mesh():
  """`scene/materials.icosphere` at order 3 gives `_icosphere_mesh`'s arrays,
  so bigscene reuses it."""
  want = jscenes._icosphere_mesh((-0.21, 0.3, 0.5), 0.16, order=3)
  got = materials.icosphere((-0.21, 0.3, 0.5), 0.16, order=3)
  for g, w in zip(got, want):
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)
  assert got[1].shape == (1280, 3)


# -------------------------------------------------- K5-K8 vs the TPU bodies


_TPU = {"fat": (jpallas.intersect_bvh_fat_pallas, jpallas.occluded_bvh_fat_pallas),
        "node": (jpallas.intersect_bvh_pallas, jpallas.occluded_bvh_pallas)}
_PLAIN = {"fat": (bvh_trace.intersect_fat_plain, bvh_trace.occluded_fat_plain),
          "node": (bvh_trace.intersect_node_plain, bvh_trace.occluded_node_plain)}


@pytest.mark.parametrize("tree,num_t,masked,seed", [
    ("fat", 600, False, 40), ("fat", 1100, True, 41),
    ("node", 600, True, 42), ("node", 1100, False, 43),
    ("node-dead", 600, True, 44), ("node-dead", 1100, False, 45)])
def test_bvh_plain_matches_tpu_kernel_body(monkeypatch, tree, num_t, masked, seed):
  """K5-K8's plain versions against the TPU kernels' bodies in interpret
  mode, on the same numpy tree; "node-dead": the node walk with dead lanes
  (empty intervals, which K5-K8 skip) among live ones."""
  rng = np.random.default_rng(seed)
  v0, e1, e2 = _tris(rng, num_t)
  o, d, t_min, t_max = _rays(rng, v0, e2, 384)
  if tree == "node-dead":
    tree = "node"
    t_max[0::7] = 0.0
    t_max[3::11] = -0.0
    t_min[1::13] = np.nan
    t_min[2::5] = np.nextafter(t_max[2::5], np.float32(np.inf))
  dead = ~(t_min <= t_max)
  mask = rng.uniform(size=num_t) > 0.3 if masked else None
  _numpy_tree(monkeypatch)
  jbvh = _jax_bvh(v0, e1, e2)
  pbvh = _port_bvh(v0, e1, e2)
  if tree == "node":
    jbvh = jbvh._replace(fat_rows=None)
    pbvh = ptypes.without_fat_rows(pbvh)
  jargs = [jnp.asarray(x) for x in (v0, e1, e2, o, d, t_min, t_max)]
  jmask = None if mask is None else jnp.asarray(mask)
  closest, occluded = _TPU[tree]
  rt, rtri, ru, rv = (np.asarray(x) for x in closest(jbvh, *jargs, jmask, interpret=True))
  rocc = np.asarray(occluded(jbvh, *jargs, jmask, interpret=True))
  tmask = None if mask is None else torch.from_numpy(mask)
  rays = _torch(o, d, t_min, t_max)
  got = _PLAIN[tree][0](pbvh, *rays, tri_mask=tmask)
  occ = _PLAIN[tree][1](pbvh, *rays, tri_mask=tmask).numpy()
  gtri = got.tri.numpy()
  full = np.ones(num_t, bool) if mask is None else mask
  tie, grazing = _ties_and_grazing(v0, e1, e2, o, d, t_min, t_max, full)
  assert not ((gtri != rtri) & ~grazing & ~tie).any()
  assert not ((occ != rocc) & ~grazing).any()
  assert (gtri == rtri).mean() > 0.98
  f = (rtri >= 0) & (gtri == rtri)
  assert f.sum() >= 50
  np.testing.assert_allclose(got.t.numpy()[f], rt[f], rtol=T_RTOL, atol=T_ATOL)
  np.testing.assert_allclose(got.u.numpy()[f], ru[f], atol=UV_ATOL)
  np.testing.assert_allclose(got.v.numpy()[f], rv[f], atol=UV_ATOL)
  # misses as the TPU kernels write them, and no ray with t_max in {-1, 0} hits
  miss = gtri < 0
  assert np.all(np.isinf(got.t.numpy()[miss])) and np.all(got.u.numpy()[miss] == 0.0)
  np.testing.assert_array_equal(np.isinf(rt), rtri < 0)
  assert np.all(gtri[t_max <= 0.0] == -1) and not occ[t_max <= 0.0].any()
  np.testing.assert_array_equal(occ, gtri >= 0)
  # an empty interval: the miss record in both
  assert np.all(gtri[dead] == -1) and np.all(rtri[dead] == -1)
  assert not occ[dead].any() and not rocc[dead].any()


def test_fat_and_node_walks_agree():
  """Both tree forms give the same closest hit on a random soup, where no
  two hits tie (at an exact tie the two walks may keep different triangles:
  a fat row tests a leaf right child before the left child's subtree)."""
  rng = np.random.default_rng(44)
  v0, e1, e2 = _tris(rng, 2000)
  pbvh = _port_bvh(v0, e1, e2)
  rays = _torch(*_rays(rng, v0, e2, 1024))
  fat = bvh_trace.intersect_fat_plain(pbvh, *rays)
  node = bvh_trace.intersect_node_plain(pbvh, *rays)
  assert all(torch.equal(a, b) for a, b in zip(fat, node))
  assert torch.equal(bvh_trace.occluded_fat_plain(pbvh, *rays), fat.found)
  assert torch.equal(bvh_trace.occluded_node_plain(pbvh, *rays), fat.found)


# ----------------------------------------------- against JAX on bigscene


@pytest.fixture(scope="module")
def room_walks(port_scene):
  """2,048 rays inside the room, their ties and grazing rays, and the
  port's four plain walks on them (fat and node trees, closest and any
  hit): one set for both JAX trees."""
  scene = port_scene[0]
  v0, e1, e2 = (x.numpy() for x in scene[:3])
  rng = np.random.default_rng(45)
  o, d, t_min, t_max = _room_rays(rng, v0, e2, 2048)
  rays = _torch(o, d, t_min, t_max)
  tie, grazing = _ties_and_grazing(v0, e1, e2, o, d, t_min, t_max, np.ones(v0.shape[0], bool))
  walks = []
  for closest, occluded in _PLAIN.values():
    bvh = scene.bvh if closest is bvh_trace.intersect_fat_plain else \
        ptypes.without_fat_rows(scene.bvh)
    walks.append((closest(bvh, *rays), occluded(bvh, *rays).numpy()))
  return (o, d, t_min, t_max), tie, grazing, walks


@pytest.mark.parametrize("jax_tree", ["default", "numpy"])
def test_bvh_plain_matches_jax_cpu_route_on_bigscene(monkeypatch, port_scene, room_walks,
                                                     jax_tree):
  """The JAX package's CPU route (`intersect_bvh`) on bigscene: on its
  default tree (whichever builder loaded) t agrees and `tri` where the
  nearest hit is not tied; on its numpy tree, the port's own, also."""
  scene = port_scene[0]
  v0, e1, e2 = (x.numpy() for x in scene[:3])
  if jax_tree == "numpy":
    _numpy_tree(monkeypatch)
  jscene = types.SimpleNamespace(tri_v0=jnp.asarray(v0), tri_e1=jnp.asarray(e1),
                                 tri_e2=jnp.asarray(e2), bvh=_jax_bvh(v0, e1, e2))
  rays, tie, grazing, walks = room_walks
  jrays = [jnp.asarray(x) for x in rays]
  ref = jtrace.trace_closest(jscene, *jrays)
  rocc = np.asarray(jtrace.trace_occluded(jscene, *jrays))
  rtri = np.asarray(ref.tri)
  for got, occ in walks:
    gtri = got.tri.numpy()
    clean = ~tie & ~grazing
    assert clean.mean() > 0.8
    np.testing.assert_array_equal(gtri[clean], rtri[clean])
    assert not (((gtri >= 0) != (rtri >= 0)) & ~grazing).any()
    f = ~grazing & (rtri >= 0)
    assert f.mean() > 0.5
    np.testing.assert_allclose(got.t.numpy()[f], np.asarray(ref.t)[f], rtol=T_RTOL, atol=T_ATOL)
    assert not ((occ != rocc) & ~grazing).any()
    np.testing.assert_array_equal(occ, gtri >= 0)


def test_dense_kernels_at_any_count_agree_with_the_bvh_on_bigscene(port_scene):
  """K1-K4 and K9a/K9b take any triangle count, as the TPU kernels do: on
  bigscene's 15,396 triangles their plain versions give the BVH walk's
  hits. K1 shares K5's triangle test, so its t is K5's bit for bit; the
  pair-tile and Woop forms agree wherever no hit ties and no edge is grazed."""
  scene = port_scene[0]
  v0, e1, e2 = (x.numpy() for x in scene[:3])
  rng = np.random.default_rng(46)
  o, d, t_min, t_max = _room_rays(rng, v0, e2, 512)
  rays = _torch(o, d, t_min, t_max)
  tris = scene[:3]
  want = bvh_trace.intersect_fat_plain(scene.bvh, *rays)
  want_occ = bvh_trace.occluded_fat_plain(scene.bvh, *rays)
  tie, grazing = _ties_and_grazing(v0, e1, e2, o, d, t_min, t_max, np.ones(v0.shape[0], bool))
  clean = ~tie & ~grazing
  assert clean.mean() > 0.8
  k1 = brute_trace.intersect_plain(*tris, *rays)
  np.testing.assert_array_equal(k1.t.numpy(), want.t.numpy())
  np.testing.assert_array_equal(k1.tri.numpy()[~tie], want.tri.numpy()[~tie])
  assert torch.equal(brute_trace.occluded_plain(*tris, *rays), want_occ)
  for mod in (brute2_trace, woop_trace):
    got = mod.intersect_plain(*tris, *rays)
    np.testing.assert_array_equal(got.tri.numpy()[clean], want.tri.numpy()[clean])
    f = clean & (want.tri.numpy() >= 0)
    assert f.mean() > 0.5
    np.testing.assert_allclose(got.t.numpy()[f], want.t.numpy()[f], rtol=T_RTOL, atol=T_ATOL)
    occ = mod.occluded_plain(*tris, *rays).numpy()
    assert not ((occ != want_occ.numpy()) & ~grazing).any()


# ------------------------------------------------------- scene and render


def test_bigscene_tables_equal_jax(jax_scene, port_arrays):
  arrays, config = port_arrays
  want = _jax_arrays(jax_scene[0])
  assert set(arrays) <= set(want)
  assert {k for k in want if k.startswith("bvh.")} == {k for k in arrays if k.startswith("bvh.")}
  for name in arrays:
    got = np.asarray(arrays[name])
    assert got.dtype == want[name].dtype and got.shape == want[name].shape, name
    np.testing.assert_array_equal(got, want[name], err_msg=name)
  jconfig = jax_scene[1]
  for f in dataclasses.fields(ptypes.SceneConfig):
    assert getattr(config, f.name) == getattr(jconfig, f.name), f.name
  assert arrays["tri_v0"].shape == (bigscene.NUM_TRIANGLES, 3)
  assert config.material_classes == (0,) and not config.spectral and config.max_path_length == 8


def test_scene_bridge_carries_the_bvh(jax_scene, port_scene):
  """The JAX tables, carried across as numpy, give the builder's scene,
  BVH and kernel tables included."""
  jscene, jconfig = jax_scene
  scene, config = scene_bridge.from_numpy(_jax_arrays(jscene), dataclasses.asdict(jconfig),
                                          device="cpu")
  want, want_config = port_scene
  assert config == want_config
  for f in ptypes.BVH._fields:
    g, w = getattr(scene.bvh, f), getattr(want.bvh, f)
    assert g.dtype == w.dtype and torch.equal(g, w), f
  # the kernel tables hold the tree: int32 ids, float32 boxes as bits
  assert_bvh_holds_tree(scene.bvh, _jax_arrays(jscene))
  assert scene.bvh.fat_table.shape == (4772, 16) and scene.bvh.prim_tris.shape == (15396, 12)


@pytest.fixture(scope="module")
def jax_render(jax_scene):
  """The JAX package's render of bigscene through K5/K6, their bodies run
  in interpret mode (its trace dispatch takes them once Pallas is
  available)."""
  scene, config = jax_scene
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jpallas, "available", lambda: True)
    for name in ("intersect_bvh_fat_pallas", "occluded_bvh_fat_pallas"):
      mp.setattr(jpallas, name, functools.partial(getattr(jpallas, name), interpret=True))
    sums, rays = jpt.render_samples_static(scene, config, 0, SPP, pool_size=POOL)
  fs = jpt.finalize_film(sums, SPP, config.film_width)
  return np.asarray(fs.camera + fs.light), np.asarray(sums.table), float(rays)


def test_render_matches_jax_pixel_by_pixel(port_scene, jax_render):
  """The whole slice: the port's render of bigscene (K5/K6's plain versions)
  against the JAX package's, at tests/test_torch_render.py's tolerances."""
  scene, config = port_scene
  sums, rays = ppt.render_samples_static(scene, config, 0, SPP, pool_size=POOL, device="cpu")
  img = pfilm.result_image(ppt.finalize_film(sums, SPP, config.film_width)).numpy()
  ref, ref_table, ref_rays = jax_render
  assert img.shape == ref.shape == (FILM[1], FILM[0], 3)
  assert np.isfinite(img).all() and (img >= 0.0).all()
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.mean() <= OUTLIER_FRACTION, outliers.mean()
  assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())
  np.testing.assert_array_equal(sums.table.numpy()[:, 12], ref_table[:, 12])
  assert int(rays) == pytest.approx(ref_rays, rel=0.005)


def test_render_without_fat_rows_matches_the_fat_render(port_scene):
  """K7/K8's plain versions render what K5/K6's render, within the whole-
  render tolerances: the two walks differ only in which of two equal hits
  they keep (a fat row tests a leaf right child's triangles before the left
  child's subtree, the node walk after it)."""
  scene, config = port_scene
  slim = scene._replace(bvh=ptypes.without_fat_rows(scene.bvh))
  a = pfilm.result_image(ppt.render(scene, config, iterations=SPP, device="cpu")).numpy()
  b = pfilm.result_image(ppt.render(slim, config, iterations=SPP, device="cpu")).numpy()
  outliers = (np.abs(b - a) > 1e-4 + 1e-3 * np.abs(a)).any(axis=-1)
  assert outliers.mean() <= OUTLIER_FRACTION, outliers.mean()
  assert abs(b.mean() - a.mean()) <= MEAN_RTOL * abs(a.mean())


def test_cpu_render_mean_inside_the_chip_check_range():
  """`chip_smoke.py` holds the 512x512, 8-spp image mean inside
  BIGSCENE_MEAN; the port's CPU render at 64x64, 16 spp lies inside it,
  with the red left third and the green right third of the Cornell box."""
  scene, config = bigscene.build_bigscene((64, 64)).build(device="cpu")
  img = pfilm.result_image(ppt.render(scene, config, iterations=16, device="cpu")).numpy()
  lo, hi = chip_smoke.BIGSCENE_MEAN
  assert lo <= float(img.mean()) <= hi, img.mean()
  assert np.isfinite(img).all() and (img >= 0.0).all()
  third = img.shape[1] // 3
  left, right = img[:, :third].mean((0, 1)), img[:, -third:].mean((0, 1))
  assert left[0] > left[1] and right[1] > right[0]
