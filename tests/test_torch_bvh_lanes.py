"""The BVH kernels' skip test, their node walk by skips, and the plain walks
on mixed lanes (CPU).

The CUDA kernels K5-K8 (`etx_tracer_tpu_torch/csrc/bvh_trace.cu`) skip a ray
whose interval is empty, !(t_min <= t_max) with NaN included
(`bvh_trace.dead_lanes`), and write its miss record at once; the plain walks
(`bvh_trace.intersect_fat_plain`, `occluded_fat_plain`, and the node forms)
walk it like any other ray. The two agree without any argument about
rounding: a valid triangle needs t >= t_min and t <= t_max, which no t
satisfies when t_min <= t_max is false. These tests hold that for float32
values at the extremes, show that the boundary t_min == t_max is walked and
hits, and hold the plain walks on bigscene rays with dead lanes interleaved
to the results of the live rays alone, which is what the kernels' packing of
live rays rests on.

K7/K8 and their plain walk go through the nodes by skips, with no stack
(word 6 of a node row: a leaf's first triangle row, an inner node's skip).
Tests here hold the node table to that layout and the skip walk to a stack
walk kept in this file: the same nodes in the same order, on seeded trees
and the comb, under hit predicates that depend on the walk's history.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from etx_tracer_tpu_torch.ops import brute_trace, bvh_build, bvh_trace
from etx_tracer_tpu_torch.scene import bigscene
from etx_tracer_tpu_torch.scene import types as scene_types

torch.set_num_threads(1)

F32 = np.float32
NAN, INF = float("nan"), float("inf")
# (t_min, t_max) pairs with an empty interval
DEAD = [(1e-4, NAN), (NAN, 1e30), (NAN, NAN), (1e-4, 0.0), (1e-4, -0.0), (0.0, -1e-45),
        (INF, 1e30), (1e-4, -INF), (INF, -INF), (1e-4, -1.0),
        (float(np.nextafter(F32(2.0), F32(3.0))), 2.0),
        (float(np.nextafter(F32(1e30), F32(INF))), 1e30)]
# ... and pairs that are not empty, however narrow
LIVE = [(0.0, 0.0), (-0.0, 0.0), (0.0, -0.0), (2.0, 2.0), (1e-4, 1e30), (-INF, INF), (INF, INF),
        (-INF, -INF), (float(np.nextafter(F32(2.0), F32(0.0))), 2.0)]

_FORMS = {"fat": (bvh_trace.intersect_fat_plain, bvh_trace.occluded_fat_plain),
          "node": (bvh_trace.intersect_node_plain, bvh_trace.occluded_node_plain)}


def _t(xs):
  return torch.tensor(xs, dtype=torch.float32)


def _f32(**kw):
  return st.floats(width=32, **kw)


@pytest.fixture(scope="module")
def big():
  """Bigscene's BVH on the CPU and 256 rays from inside its room."""
  scene, _ = chip_smoke.bigscene_scene((16, 16), "cpu")
  rng = np.random.default_rng(11)
  rays = chip_smoke.test_rays(rng, *scene[:3], 256, "cpu", chip_smoke.ROOM)
  return scene.bvh, rays


def _tree(v0, e1, e2):
  arrays = {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
            **{f"bvh.{k}": v for k, v in bvh_build.build_bvh(v0, e1, e2).items()}}
  return scene_types.bvh_from_arrays(bvh_build.kernel_tables(arrays), "cpu")


def _axis_aligned_scene():
  """A tree whose triangle 0 lies in the plane z = 2 (v0 = (0, 0, 2), e1 =
  x, e2 = y), beside 40 small triangles far from it, so the root has inner
  children and the tree has fat rows."""
  rng = np.random.default_rng(3)
  v0 = np.concatenate([[[0.0, 0.0, 2.0]], rng.uniform(5.0, 9.0, (40, 3))]).astype(F32)
  e1 = np.concatenate([[[1.0, 0.0, 0.0]], rng.uniform(-0.3, 0.3, (40, 3))]).astype(F32)
  e2 = np.concatenate([[[0.0, 1.0, 0.0]], rng.uniform(-0.3, 0.3, (40, 3))]).astype(F32)
  return _tree(v0, e1, e2)


def test_dead_lanes_is_the_empty_interval():
  lo, hi = _t([p[0] for p in DEAD]), _t([p[1] for p in DEAD])
  assert bool(bvh_trace.dead_lanes(lo, hi).all())
  lo, hi = _t([p[0] for p in LIVE]), _t([p[1] for p in LIVE])
  assert not bool(bvh_trace.dead_lanes(lo, hi).any())


@settings(max_examples=400, deadline=None)
@given(t_min=_f32(), t_max=_f32(), t=_f32())
def test_no_t_lies_in_an_empty_interval(t_min, t_max, t):
  # the interval part of the triangle test (`brute_trace._mt`), as it
  # compares in float32: an empty interval admits no t, NaN and +-inf too
  lo, hi, tt = _t([t_min]), _t([t_max]), _t([t])
  dead = bool(bvh_trace.dead_lanes(lo, hi))
  assert dead == (not F32(t_min) <= F32(t_max))
  if dead:
    assert not bool((tt >= lo) & (tt <= hi))


@pytest.mark.parametrize("form", ["fat", "node"])
@pytest.mark.parametrize("t_min,t_max", DEAD)
def test_plain_walks_give_a_dead_lane_the_miss_record(big, form, t_min, t_max):
  bvh, (o, d, _, _) = big
  if form == "node":
    bvh = scene_types.without_fat_rows(bvh)
  lo, hi = torch.full_like(o[:, 0], t_min), torch.full_like(o[:, 0], t_max)
  closest, occluded = _FORMS[form]
  hit = closest(bvh, o, d, lo, hi)
  assert bool(torch.isinf(hit.t).all()) and bool((hit.t > 0).all())
  assert bool((hit.tri == -1).all())
  assert bool((hit.u == 0.0).all()) and bool((hit.v == 0.0).all())
  assert not bool(occluded(bvh, o, d, lo, hi).any())


@pytest.mark.parametrize("form", ["fat", "node"])
def test_an_interval_of_one_point_is_walked_and_hits(form):
  bvh = _axis_aligned_scene()
  assert bvh.fat_table is not None
  if form == "node":
    bvh = scene_types.without_fat_rows(bvh)
  o = _t([[0.25, 0.25, 0.0]])
  d = _t([[0.0, 0.0, 1.0]])
  # the hit's t is exactly 2: det = -1, t = (e2 . q) / det = -2 / -1
  ok, t, u, v = brute_trace._mt(_t([[0.0, 0.0, 2.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0]]).unbind(1),
                                *o.unbind(1), *d.unbind(1), _t([0.0]), _t([10.0]))
  assert bool(ok) and float(t) == 2.0
  closest, occluded = _FORMS[form]
  for lo, hi, hits in ((2.0, 2.0, True), (float(np.nextafter(F32(2.0), F32(3.0))), 2.0, False),
                       (2.0, float(np.nextafter(F32(2.0), F32(0.0))), False)):
    lo_t, hi_t = _t([lo]), _t([hi])
    assert bool(bvh_trace.dead_lanes(lo_t, hi_t)) == (not hits)
    hit = closest(bvh, o, d, lo_t, hi_t)
    assert bool(hit.found) == hits and bool(occluded(bvh, o, d, lo_t, hi_t)) == hits
    if hits:
      assert int(hit.tri) == 0 and float(hit.t) == 2.0
      assert float(hit.u) == 0.25 and float(hit.v) == 0.25


@pytest.mark.parametrize("form,masked", [("fat", False), ("fat", True), ("node", False),
                                         ("node", True)])
@settings(max_examples=8, deadline=None)
@given(dead=st.lists(st.booleans(), min_size=64, max_size=64),
       interval=st.sampled_from(DEAD), offset=st.integers(0, 192))
def test_plain_walks_on_dead_lanes_interleaved(big, form, masked, dead, interval, offset):
  bvh, rays = big
  if form == "node":
    bvh = scene_types.without_fat_rows(bvh)
  o, d, lo, hi = (x[offset:offset + 64] for x in rays)
  mask = None
  if masked:
    num_t = bvh.prim_tris.shape[0]
    mask = torch.from_numpy(np.random.default_rng(offset).uniform(size=num_t) > 0.3)
  made_dead = torch.tensor(dead)
  # a few test rays have t_max = -1 (dead already); the lanes made dead too
  dead = bvh_trace.dead_lanes(lo, hi) | made_dead
  lo = torch.where(made_dead, interval[0], lo)
  hi = torch.where(made_dead, interval[1], hi)
  assert torch.equal(bvh_trace.dead_lanes(lo, hi), dead)
  closest, occluded = _FORMS[form]
  hit = closest(bvh, o, d, lo, hi, tri_mask=mask)
  occ = occluded(bvh, o, d, lo, hi, tri_mask=mask)
  live = ~dead
  alone = closest(bvh, o[live], d[live], lo[live], hi[live], tri_mask=mask)
  for got, want in zip(hit, alone):
    assert torch.equal(got[live], want)
  assert torch.equal(occ[live], occluded(bvh, o[live], d[live], lo[live], hi[live],
                                         tri_mask=mask))
  # a dead lane gets the miss record: t = +inf, tri = -1, u = v = 0
  assert bool(torch.isinf(hit.t[dead]).all()) and bool((hit.tri[dead] == -1).all())
  assert bool((hit.u[dead] == 0.0).all()) and bool((hit.v[dead] == 0.0).all())
  assert not bool(occ[dead].any())
  assert torch.equal(occ, hit.found)


def test_lane_variants_hold_the_patterns_the_kernels_skip(big):
  _, rays = big
  base = bvh_trace.dead_lanes(rays[2], rays[3])
  assert 0 < int(base.sum()) < base.numel() // 8
  for label, (o, d, lo, hi) in chip_smoke.lane_variants(rays).items():
    dead = bvh_trace.dead_lanes(lo, hi)
    if label.startswith("NaN"):
      assert torch.equal(dead, base | torch.isnan(lo)) and bool(torch.isnan(lo[1::3]).all())
    elif label.startswith("t_min one ulp"):
      assert bool(dead[::2].all()) and torch.equal(dead[1::2], base[1::2])
    elif label == "all dead":
      assert bool(dead.all())
    elif label in ("t_max == t_min", "t_min = t_max = 0"):
      assert not bool(dead.any())


def test_per_ray_counts_add_up_to_the_walks_totals(big):
  bvh, rays = big
  for form, any_hit in (("fat", False), ("fat", True), ("node", False), ("node", True)):
    b = bvh if form == "fat" else scene_types.without_fat_rows(bvh)
    zeros = lambda: torch.zeros(rays[0].shape[0], dtype=torch.int64)
    stats = {"boxes": 0, "tris": 0, "ray_rows": zeros(), "ray_tris": zeros()}
    _FORMS[form][any_hit](b, *rays, stats=stats)
    assert int(stats["ray_rows"].sum()) * (2 if form == "fat" else 1) == stats["boxes"]
    assert int(stats["ray_tris"].sum()) == stats["tris"]
    assert bool((stats["ray_rows"] >= 1).all())


def test_plain_walks_take_a_stack_as_deep_as_the_kernels_do():
  # a comb 61 levels deep: the fat walk pushes 60 of the 64 entries (the
  # node walk needs no stack); every box is the scene's, so the walk tests
  # every triangle, in index order
  rng = np.random.default_rng(21)
  arrays = chip_smoke.comb_arrays(rng, 61)
  tris = [torch.from_numpy(arrays[k]) for k in ("tri_v0", "tri_e1", "tri_e2")]
  bvh = scene_types.bvh_from_arrays(bvh_build.kernel_tables(arrays), "cpu")
  left, count = arrays["bvh.node_left"], arrays["bvh.node_count"]
  assert bvh_build.tree_depth(left, count) == 61 <= bvh_build.STACK_DEPTH
  assert bvh.fat_table.shape[0] == 121
  rays = chip_smoke.test_rays(rng, *tris, 256, "cpu")
  want = brute_trace.intersect_plain(*tris, *rays)
  assert 0.1 < float(want.found.float().mean()) < 0.9
  for closest, occluded in _FORMS.values():
    b = bvh if closest is bvh_trace.intersect_fat_plain else scene_types.without_fat_rows(bvh)
    hit = closest(b, *rays)
    assert torch.equal(hit.t, want.t) and torch.equal(hit.tri, want.tri)
    assert torch.equal(occluded(b, *rays), want.found)


def test_work_line_counts_the_lane_slots_of_warps_of_32():
  # one warp of 31 one-row walks and a 32-row walk, then a warp of 4 rays
  # padded to 32 lanes: useful slots over the slots each warp holds
  rows = torch.tensor([1] * 31 + [32] + [2, 2, 2, 2])
  tris = torch.tensor([0] * 36)
  line = chip_smoke.walk_line(rows, tris, fat=True)
  share = (31 + 32 + 8) / (32 * 32 + 32 * 2)
  assert f"fat rows a ray mean {71 / 36:.2f} p99 " in line
  assert f"max 32, useful lane share {share:.3f}" in line
  assert "triangle tests a ray mean 0.00 p99 0 max 0, useful lane share 0.000" in line


def _subtree_ends(node_left, node_count):
  """end[i]: the first node after subtree(i) in pre-order, by recursion on
  the tree (a leaf ends at i + 1, an inner node where its right child's
  subtree ends), not by `bvh_build.compute_skip`."""
  end = np.zeros(len(node_left), np.int64)
  for i in reversed(range(len(node_left))):   # a right child follows its parent
    end[i] = i + 1 if node_count[i] > 0 or len(node_left) == 1 else end[node_left[i]]
  return end


def _tree_arrays(which):
  if which == "bigscene":
    return bigscene.build_bigscene((16, 16)).arrays()[0]
  if which == "comb":
    return chip_smoke.comb_arrays(np.random.default_rng(21), 61)
  rng = np.random.default_rng(int(which.removeprefix("soup")))
  num_t = int(which.removeprefix("soup"))
  v0 = rng.uniform(-1.0, 1.0, (num_t, 3)).astype(F32)
  e1 = rng.uniform(-0.4, 0.4, (num_t, 3)).astype(F32)
  e2 = rng.uniform(-0.4, 0.4, (num_t, 3)).astype(F32)
  return {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
          **{f"bvh.{k}": v for k, v in bvh_build.build_bvh(v0, e1, e2).items()}}


@pytest.mark.parametrize("which", ["bigscene", "comb"])
def test_node_word6_is_a_leafs_first_triangle_or_an_inner_nodes_skip(which):
  arrays = _tree_arrays(which)
  left, count = arrays["bvh.node_left"], arrays["bvh.node_count"]
  table = bvh_build.kernel_tables(arrays)["bvh.node_table"]
  assert table.dtype == np.int32 and table.shape == (len(left), 8)
  word6, leaf = table[:, 6], count > 0
  assert leaf.any() and (~leaf).any()
  np.testing.assert_array_equal(word6[leaf], left[leaf])
  np.testing.assert_array_equal(word6[~leaf], _subtree_ends(left, count)[~leaf])
  np.testing.assert_array_equal(table[:, 7], count)
  # an inner node's left child is the next node, its right child the next
  # node's skip; a leaf's skip is its own index + 1
  inner = np.flatnonzero(~leaf)
  ends = _subtree_ends(left, count)
  np.testing.assert_array_equal(ends[inner + 1], left[inner])
  np.testing.assert_array_equal(ends[leaf], np.flatnonzero(leaf) + 1)


def _stack_walk(left, count, hit):
  """The nodes a stack walk visits: at a hit inner node it pushes the right
  child and goes to the next node; at a leaf or a missed node it pops, or
  ends. `hit(node, k)`, k the hit leaves so far."""
  seen, stack, node, k = [], [], 0, 0
  while True:
    seen.append(node)
    h = hit(node, k)
    if h and count[node] > 0:
      k += 1
    if h and count[node] == 0:
      stack.append(int(left[node]))
      node += 1
    elif stack:
      node = stack.pop()
    else:
      return seen


def _skip_walk(table, hit):
  """The nodes the kernels' skip walk visits over a node table."""
  seen, node, k = [], 0, 0
  word6, count = table[:, 6], table[:, 7]
  while node < table.shape[0]:
    seen.append(node)
    h = hit(node, k)
    if h and count[node] > 0:
      k += 1
    node = node + 1 if h or count[node] > 0 else int(word6[node])
  return seen


@pytest.mark.parametrize("which", ["soup1", "soup5", "soup9", "soup60", "soup700", "soup2500",
                                   "soup5000", "comb"])
def test_skip_walk_visits_the_stack_walks_nodes_in_order(which):
  arrays = _tree_arrays(which)
  left, count = arrays["bvh.node_left"], arrays["bvh.node_count"]
  table = bvh_build.kernel_tables(arrays)["bvh.node_table"]
  n = len(left)
  rng = np.random.default_rng(n)
  jumped = False
  for p in (0.0, 0.3, 0.6, 0.85, 1.0) * 8:
    # whether a node's box is hit depends on the hit leaves so far, as the
    # closest hit's cap depends on the triangles it found
    draws = rng.uniform(size=(n, 4))
    hit = lambda node, k: bool(draws[node, k % 4] < p)
    seen = _stack_walk(left, count, hit)
    assert _skip_walk(table, hit) == seen
    # a walk that passed over a missed subtree and went on
    jumped |= seen != list(range(len(seen)))
    if p == 1.0:
      assert seen == list(range(n))
  # ... wherever an inner node's subtree has a node after it
  assert jumped or not ((table[:, 7] == 0) & (table[:, 6] < n)).any()
