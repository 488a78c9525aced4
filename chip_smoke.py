"""Smoke test of the PyTorch/CUDA port (`etx_tracer_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each with its elapsed seconds:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel source of the port (`csrc/`), one
     process per source, all started together, and reports each kernel's
     registers, spills and stack frame;
  3. K1 closest hit and 4. K2 any hit: each kernel against its plain PyTorch
     version on the card, on 2^18 rays against the Cornell triangles and a
     random 128-triangle soup, and on 2^16 rays against the materials
     scene's 996 and bigscene's 15,396 triangles (the kernels take any
     count; the dispatch sends them at most 128), with and without masked
     rows; rays include axis-parallel ones, rays aimed at shared edges and
     vertices, and rays with t_max = -1; on the tables of at most 1,024
     triangles also under the eight lane patterns of phase 5. Times each
     kernel and its plain version at 2^18 rays x 36 triangles, and K1's at
     2^16 rays x 15,396, with each launch's blocks per SM, rays a block and
     waves; then holds both against their plain versions on narrow batches
     of 2^12, 2^14 and 2^16 live rays against the Cornell triangles and
     times them there, with their launch shape;
  5. K3 pair-tile closest hit and 6. K4 pair-tile any hit: the same checks
     on 2^18 rays against the materials scene's 996 triangles, random
     4096- and 4097-triangle soups, a 129-triangle soup, the Cornell
     triangles and bigscene's 15,396, and on 2^16 of those rays under eight
     lane patterns (every other lane dead, all dead, one live ray per warp,
     t_max == t_min, t_min = t_max = 0, a NaN t_min on every third lane,
     t_min one ulp above t_max on every other lane, strided rays); timed,
     with the plain version, at 2^18 rays x 996 triangles, K3 also x 15,396,
     with each kernel's blocks per SM and waves;
  7. K5 fat-row BVH closest hit and 8. K6 fat-row any hit, then 9. K7
     plain-node BVH closest hit and 10. K8 plain-node any hit: the same
     checks on 2^18 rays against bigscene's tree (15,396 triangles, origins
     inside the room) and the tree of a random 5000-triangle soup, and on
     2^16 rays against a comb 61 levels deep (its fat walk pushes 60 stack
     entries), with and without masked rows, and on 2^14 of those rays under
     the eight lane patterns; K7/K8 walk the same trees without their fat
     rows. Timed at 2^18 rays against bigscene; each bound counts the box
     and triangle tests the plain version's walk makes for the rays whose
     interval is not empty; a per-ray work line gives the plain walk's rows
     and triangle tests a ray (mean, p99, max) and the share of lane slots
     that carry a step when one thread walks one ray; K5/K6 also print their
     blocks per SM and persistent grid;
  11. K9a Woop closest hit and 12. K9b Woop any hit: the same checks on
     2^18 rays against the materials (996), caustics (1,060) and bigscene
     (dense, 15,396) scenes and the 4096- and 129-triangle soups, and on
     2^16 of those rays under the eight lane patterns (all but bigscene);
     timed, with the plain version, at 2^18 rays x 996 triangles, K9a also
     x 15,396, with each launch's blocks per SM and waves; then both held
     against their plain versions and timed on narrow batches of 2^12 and
     2^14 live rays against the materials scene; then, for comparison only,
     the time of the FP32 `torch.matmul` of the
     (R, 8) x (8, 6 x 512) products that the TPU kernel hands to its matrix
     unit;
  13. main path, Cornell: the diffuse Cornell box at 512x512, max path
     length 1023, a 2^18-lane pool and 64 iterations through
     `render_samples_static` and `finalize_film` (what `path_tracing.render`
     runs), with every kernel launch counted; then one iteration of it under
     the profiler, to show where a bounce's time goes and each trace
     kernel's device time per launch; then the closest-hit and shadow rays
     of bounce 2 of one more iteration, captured as the main path traces
     them (dead lanes at t_max = 0), with K1 and K2 held against their plain
     versions and timed on them, beside their live share and bound;
  14. main path, materials: the spectral materials showcase (996 triangles:
     Diffuse, Conductor, Dielectric and Thinfilm) at 512x512, max path
     length 16, a 2^18-lane pool and 8 iterations, counted and profiled the
     same way; then the closest-hit and shadow rays of bounce 2 of one more
     iteration, captured as the main path traces them (dead lanes at
     t_max = 0), with K3 and K4 held against their plain versions and timed
     on them, beside their live share and bound;
  15. main path, bigscene: twelve icospheres in the Cornell box (15,396
     triangles, Diffuse, RGB) at 512x512, max path length 8, a 2^18-lane
     pool and 8 iterations, traced by K5/K6, counted and profiled the same
     way; then its bounce-2 rays captured as the materials path's are, with
     K5 and K6 held against the plain walk and timed on them, beside their
     live share, bound and per-ray work;
  16. end to end: the golden 32x32 Cornell render (max path length 6, 4 spp)
     on the card against the same render on the CPU and the JAX package's
     recorded golden values; the 32x32 materials render (4 spp) on the card
     against the same render on the CPU; the 32x32 bigscene render (8 spp)
     on the card against the CPU, through K5/K6, and again with the tree's
     fat rows removed, through K7/K8;
  17. micro: the micro-benchmark entry
     (`etx_tracer_tpu_torch/benchmarks/micro.py`) runs its four trace
     groups at full width (`trace`: K5 and K1 on 2^16 rays of three kinds
     against bigscene; `trace_brute`: K3/K4 against K9a/K9b on 2^18 random
     rays against materials, caustics and bigscene; `trace_sorted` and
     `trace_oracle`: K5 on sorted rays) and prints its lines, with the launch
     counts set to 0 before each group and read after; checks that K5 and
     K1 give equal t, that sorted rays get their unsorted hits, and prints
     K9a's agreement with K3 (the share of equal `tri`, the largest relative
     |dt|). K9a/K9b's launches in the `kernels` line are `trace_brute`'s.

Any failed check raises, so the script exits non-zero. After every phase has
passed it prints one JSON line with each kernel's numbers and, as its last
line, {"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result. The script imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from etx_tracer_tpu_torch.core import spectrum
from etx_tracer_tpu_torch.models import path_tracing
from etx_tracer_tpu_torch.benchmarks import micro
from etx_tracer_tpu_torch.ops import _build, brute2_trace, brute_trace, bvh_build, bvh_trace
from etx_tracer_tpu_torch.ops import woop_trace
from etx_tracer_tpu_torch.render import film as film_mod
from etx_tracer_tpu_torch.scene import bigscene, caustics, cornell, materials
from etx_tracer_tpu_torch.scene import types as scene_types

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# FP32 adds, subtracts and multiplies per ray-triangle pair (Woop: 18 for
# w = A o + b, 15 for q = A d, the division, 4 for u and v, 1 for u + v)
FLOPS_PER_PAIR = {brute_trace: 44, brute2_trace: 48, woop_trace: 39}
# bytes of one triangle as the kernel reads it: v0, e1, e2 (K1-K4) or a
# 12-float Woop row (K9a/K9b)
TRI_BYTES = {brute_trace: 36, brute2_trace: 36, woop_trace: 48}
# ... per BVH triangle test (`_tri_hit`: 45 and a division) and per box
# slab test (12 for the three slabs, 2 for the conservative far bound; the
# 12 min/max and the compares not counted), from csrc/bvh_trace.cu
FLOPS_PER_BVH_TRI = 45
FLOPS_PER_BOX = 14

# the JAX package's golden values for the 32x32 render (tests/test_golden.py)
GOLDEN_MEAN = np.array([0.12571028, 0.05596193, 0.00888113])
GOLDEN_TOTAL = 195.1266
GOLDEN_RTOL = 2e-3

# kernel vs plain version: the same arithmetic in the same order, built with
# -fmad=false, so bit-equal results are expected; the check allows t, u, v
# to differ by this much relative to max(1, |value|), and tri not at all
KERNEL_ATOL = 1e-6

RAYS = 1 << 18
# rays of a K1/K2 check case against thousands of triangles, where the plain
# versions' per-triangle loops are slow (seconds a call at 2^16 x 15,396)
FEW_RAYS = 1 << 16
# rays of a BVH kernel's lane patterns: the plain walk's time grows with its
# longest walk, about a second a call on the card
BVH_LANE_RAYS = 1 << 14
# K1/K2's lane patterns run on tables of at most this many triangles: their
# plain versions loop over the triangles, seconds a call at 15,396
BRUTE_LANE_TRIS = 1024
# ... and K9a/K9b's on tables of at most this many (all but bigscene's)
WOOP_LANE_TRIS = 4096
# the narrow batches K1/K2 are held and timed on: the cascade's phase widths
NARROW = (1 << 12, 1 << 14, 1 << 16)
# ... and K9a/K9b's, against the materials scene
WOOP_NARROW = (1 << 12, 1 << 14)
ITERATIONS = 64  # Cornell main-path samples per pixel: one chunk of the JAX package's bench
# materials main path: one `_pt_mrays` call of the JAX package's bench
MATERIALS_ITERATIONS = 8
# the materials image mean at 512x512, 8 spp must lie in this range: the
# port's CPU render of the scene in tests/test_torch_materials.py (16x16,
# 2 spp) has mean 0.0666, and that test holds it inside this range, which is
# that mean +-10%
MATERIALS_MEAN = (0.060, 0.0733)
# card vs CPU, end to end: the tolerances the CPU tests hold the port to
# against the JAX package (tests/test_torch_render.py, test_torch_materials.py)
E2E_OUTLIERS = 0.02
E2E_MEAN_RTOL = 0.005
# bigscene main path: one `_pt_mrays` call of the JAX package's bench
BIGSCENE_ITERATIONS = 8
# the bigscene image mean at 512x512, 8 spp must lie in this range: the
# port's CPU render of the scene at 64x64, 16 spp has mean 0.06337 (and at
# 32x32, 8 spp 0.06316); tests/test_torch_bigscene.py holds that 64x64 mean
# inside this range, which is 0.06337 +-10%
BIGSCENE_MEAN = (0.0570, 0.0697)
# the materials main path's bounce whose rays K3/K4 are held and timed on
CAPTURE_BOUNCE = 2
T0 = time.perf_counter()


def say(phase: str, msg: str):
  print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def check(cond: bool, what: str):
  if not cond:
    raise AssertionError(what)


# ------------------------------------------------------------------- timing


def event_ms(fn, reps: int) -> float:
  """Mean milliseconds per call, by CUDA events around `reps` calls."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel_name: str, reps: int) -> float:
  """Device time per call of the kernels whose names contain `kernel_name`,
  from the profiler's trace of `reps` calls: each such kernel's mean time per
  launch, summed (K6 launches two a call, its pack and walk kernels). A mean
  per launch, not a total over the calls: the profiler may drop some of a
  trace's kernel records (and a trace with none is taken again, up to three
  times)."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  for _ in range(3):  # a trace that lost every record is taken again
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    per_launch = [ev.device_time_total / ev.count for ev in prof.key_averages()
                  if kernel_name in ev.key and ev.count > 0 and ev.device_time_total > 0.0]
    if per_launch:
      return sum(per_launch) / 1e3
  raise AssertionError(f"the profiler recorded no {kernel_name} launch in three traces")


def bound_ms(ops: int, nbytes: int):
  """Least time the card could take: the larger of the operations over the
  FP32 peak and the bytes over the HBM peak. Returns (ms, bound_by)."""
  t_ops = ops / PEAK_FP32_FLOPS
  t_bytes = nbytes / PEAK_HBM_BYTES
  return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------------- inputs


def tri_soup(rng, n: int, dev):
  v0 = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
  e1 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
  e2 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
  return [torch.from_numpy(a).to(dev) for a in (v0, e1, e2)]


def soup_tree(rng, n: int, dev):
  """(triangle arrays, BVH) of a random n-triangle soup, the tree built as
  a scene's is."""
  tris = tri_soup(rng, n, dev)
  v0, e1, e2 = (x.cpu().numpy() for x in tris)
  tree = bvh_build.build_bvh(v0, e1, e2)
  arrays = {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
            **{f"bvh.{k}": v for k, v in tree.items()}}
  return tris, scene_types.bvh_from_arrays(bvh_build.kernel_tables(arrays), dev)


def comb_tree(rng, depth: int, dev):
  """(triangle arrays, BVH) of a comb of `depth` levels: spine node k has
  spine node k + 1 as its left child and, as its right child, an inner node
  over two one-triangle leaves; the last spine node has two leaves. Every
  box is the scene's, so a ray from inside walks every row, and its fat walk
  pushes depth - 1 entries: a stack deeper than any scene's so far (depth 61
  pushes 60 of the kernels' 64)."""
  num_t = 2 * depth
  v0 = rng.uniform(-1.0, 1.0, (num_t, 3)).astype(np.float32)
  e1 = rng.uniform(-0.5, 0.5, (num_t, 3)).astype(np.float32)
  e2 = rng.uniform(-0.5, 0.5, (num_t, 3)).astype(np.float32)
  corners = np.stack([v0, v0 + e1, v0 + e2])
  lo, hi = corners.min(axis=(0, 1)), corners.max(axis=(0, 1))
  left, count = [], []

  def node(n_tris, first=0):
    left.append(first)
    count.append(n_tris)
    return len(left) - 1

  def leaf():
    return node(1, sum(count))

  def two_leaves(i):
    leaf()
    left[i] = leaf()

  for _ in range(depth - 1):   # pre-order: the spine first, then the pairs
    node(0)
  spine = list(range(depth - 1))
  last = node(0)
  two_leaves(last)
  for k in reversed(spine):
    left[k] = node(0)
    two_leaves(left[k])
  tree = {"node_min": np.tile(lo, (len(left), 1)), "node_max": np.tile(hi, (len(left), 1)),
          "node_left": np.asarray(left, np.int32), "node_count": np.asarray(count, np.int32),
          "prim_index": np.arange(num_t, dtype=np.int32)}
  tree["fat_rows"] = bvh_build.build_fat_rows(tree["node_min"], tree["node_max"],
                                             tree["node_left"], tree["node_count"])
  arrays = {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
            **{f"bvh.{k}": v for k, v in tree.items()}}
  tris = [torch.from_numpy(a).to(dev) for a in (v0, e1, e2)]
  return tris, scene_types.bvh_from_arrays(bvh_build.kernel_tables(arrays), dev)


def test_rays(rng, v0, e1, e2, n: int, dev, inside=None):
  """n rays: random ones, axis-parallel ones, ones aimed at shared triangle
  edges and vertices, and ones with t_max = -1 (padded or dead lanes).
  Origins lie in the triangles' bounding box grown by 0.5, or in the box
  `inside` = (lo, hi) when given."""
  v0, e1, e2 = (x.cpu().numpy() for x in (v0, e1, e2))
  lo, hi = inside if inside is not None else (v0.min(0) - 0.5, v0.max(0) + 0.5)
  o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
  d = rng.normal(size=(n, 3)).astype(np.float32)
  q = n // 8
  # axis-parallel directions
  axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
  d[:q] = axes[rng.integers(0, 6, q)]
  # aimed at points on the edge v0 -> v0 + e2 of a triangle, which a quad
  # or a sphere shares with its neighbour, and at vertices
  ti = rng.integers(0, v0.shape[0], q)
  s = rng.uniform(0.0, 1.0, (q, 1)).astype(np.float32)
  s[: q // 4] = 0.0  # vertices
  target = v0[ti] + s * e2[ti]
  d[q:2 * q] = target - o[q:2 * q]
  d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
  t_min = np.full(n, 1e-4, np.float32)
  t_max = np.full(n, 1e30, np.float32)
  t_max[2 * q:2 * q + q // 4] = -1.0
  t_max[2 * q + q // 4:2 * q + q // 2] = rng.uniform(0.0, 3.0, q // 4)
  return [torch.from_numpy(a).to(dev) for a in (o, d, t_min, t_max)]


ROOM = ((-0.95, 0.05, -0.95), (0.95, 1.95, 0.95))  # inside the Cornell room


def cornell_scene(film, mpl, dev):
  return cornell.build_cornell_box(film_size=film, diffuse_only=True,
                                   max_path_length=mpl).build(device=dev)


def materials_scene(film, dev):
  return materials.build_materials_scene(film).build(device=dev)


def bigscene_scene(film, dev, fat_rows=True):
  """Bigscene on `dev`; without fat rows the trace dispatch takes K7/K8."""
  scene, config = bigscene.build_bigscene(film).build(device=dev)
  if not fat_rows:
    scene = scene._replace(bvh=scene_types.without_fat_rows(scene.bvh))
  return scene, config


def first_hit_pairs(v0, e1, e2, o, d, t_min, t_max, live, mask=None) -> int:
  """Ray-triangle pairs an any-hit loop over the triangles in index order
  that stops at the first hit needs, for the rays `live` (K2's)."""
  first = torch.full_like(t_max, float(v0.shape[0]))
  for ti in reversed(range(v0.shape[0])):
    if mask is not None and not bool(mask[ti]):
      continue
    one = brute_trace.occluded_plain(v0[ti:ti + 1], e1[ti:ti + 1], e2[ti:ti + 1],
                                     o, d, t_min, t_max)
    first = torch.where(one, float(ti + 1), first)
  return int(torch.where(live, first, 0.0).sum().item())


def first_hit_pairs_chunked(mod, v0, e1, e2, o, d, t_min, t_max) -> int:
  """Ray-triangle pairs K4's or K9b's any-hit loop tests: up to each ray's
  first valid pair, by the kernel's own validity test (`mod._pairs`), one
  512-triangle chunk at a time, for the rays that its skip test
  (`mod.dead_lanes`) does not find dead."""
  if mod is woop_trace:
    tab = woop_trace.woop_tables(v0, e1, e2)
    valid = lambda c, ray: woop_trace._pairs(tab[c], ray)[0]
  else:
    valid = lambda c, ray: brute2_trace._pairs(v0[c], e1[c], e2[c], ray)[0]
  num_t = v0.shape[0]
  total = 0
  for sl, ray in mod._ray_tiles(o, d, t_min, t_max):
    first = torch.full((ray[0].shape[0],), num_t, dtype=torch.int64, device=o.device)
    for s in range(0, num_t, mod.CHUNK):
      ok = valid(slice(s, s + mod.CHUNK), ray)
      width = ok.shape[1]
      rev = torch.arange(width, 0, -1, device=o.device)   # width - j: the first wins
      at = s + width - (ok * rev).amax(dim=1)             # first valid index
      first = torch.minimum(first, torch.where(ok.any(dim=1), at + 1, num_t))
    total += int(torch.where(mod.dead_lanes(t_min[sl], t_max[sl]), 0, first).sum().item())
  return total


# ------------------------------------------------------------------- phases

KERNELS = {
    # name: (wrapper module, entry, profiler kernel name, replaces, source)
    "intersect": (brute_trace, "intersect", "brute_intersect_kernel",
                  "etx_tracer_tpu/ops/pallas_trace.py:111",
                  "etx_tracer_tpu_torch/csrc/brute_trace.cu"),
    "occluded": (brute_trace, "occluded", "brute_intersect_kernel",
                 "etx_tracer_tpu/ops/pallas_trace.py:903",
                 "etx_tracer_tpu_torch/csrc/brute_trace.cu"),
    "intersect_brute2": (brute2_trace, "intersect", "brute2_kernel",
                         "etx_tracer_tpu/ops/pallas_trace.py:1121",
                         "etx_tracer_tpu_torch/csrc/brute2_trace.cu"),
    "occluded_brute2": (brute2_trace, "occluded", "brute2_kernel",
                        "etx_tracer_tpu/ops/pallas_trace.py:1148",
                        "etx_tracer_tpu_torch/csrc/brute2_trace.cu"),
    "intersect_bvh_fat": (bvh_trace, "intersect_fat", "bvh_fat_kernel",
                          "etx_tracer_tpu/ops/pallas_trace.py:781",
                          "etx_tracer_tpu_torch/csrc/bvh_trace.cu"),
    "occluded_bvh_fat": (bvh_trace, "occluded_fat", "bvh_fat_kernel",
                         "etx_tracer_tpu/ops/pallas_trace.py:818",
                         "etx_tracer_tpu_torch/csrc/bvh_trace.cu"),
    "intersect_bvh": (bvh_trace, "intersect_node", "bvh_node_kernel",
                      "etx_tracer_tpu/ops/pallas_trace.py:482",
                      "etx_tracer_tpu_torch/csrc/bvh_trace.cu"),
    "occluded_bvh": (bvh_trace, "occluded_node", "bvh_node_kernel",
                     "etx_tracer_tpu/ops/pallas_trace.py:524",
                     "etx_tracer_tpu_torch/csrc/bvh_trace.cu"),
    "intersect_woop": (woop_trace, "intersect", "woop_kernel",
                       "etx_tracer_tpu/ops/pallas_trace.py:1365",
                       "etx_tracer_tpu_torch/csrc/woop_trace.cu"),
    "occluded_woop": (woop_trace, "occluded", "woop_kernel",
                      "etx_tracer_tpu/ops/pallas_trace.py:1392",
                      "etx_tracer_tpu_torch/csrc/woop_trace.cu"),
}
CLOSEST = ("intersect", "intersect_brute2", "intersect_bvh_fat", "intersect_bvh",
           "intersect_woop")


def reset_counts():
  for mod in (brute_trace, brute2_trace, bvh_trace, woop_trace):
    for key in mod.launches:
      mod.launches[key] = 0


def read_counts():
  return {name: mod.launches[entry] for name, (mod, entry, *_) in KERNELS.items()}


def kernel_call(name, geometry, plain=False):
  """The kernel's wrapper (or its plain version) bound to its geometry: the
  triangle arrays for K1-K4, the BVH for K5-K8."""
  mod, entry = KERNELS[name][:2]
  fn = getattr(mod, f"{entry}_plain" if plain else entry)
  tris, bvh = geometry
  head = [bvh] if mod is bvh_trace else list(tris)
  return lambda *rays, tri_mask=None: fn(*head, *rays, tri_mask=tri_mask)


def compare_intersect(name, geometry, rays, mask):
  hit = kernel_call(name, geometry)(*rays, tri_mask=mask)
  ref = kernel_call(name, geometry, plain=True)(*rays, tri_mask=mask)
  torch.cuda.synchronize()
  check(torch.equal(hit.tri, ref.tri), f"{name}: tri differs from the plain version")
  found = ref.tri >= 0
  check(torch.equal(torch.isinf(hit.t), torch.isinf(ref.t)), f"{name}: misses differ")
  err = 0.0
  for a, b in ((hit.t, ref.t), (hit.u, ref.u), (hit.v, ref.v)):
    diff = torch.where(found, (a - b).abs(), 0.0)
    check(bool((diff <= KERNEL_ATOL * torch.clamp(b.abs(), min=1.0)).all()),
          f"{name}: t/u/v differ from the plain version by up to {diff.max().item()}")
    err = max(err, diff.max().item())
  return err, float(found.float().mean().item())


def compare_occluded(name, geometry, rays, mask):
  occ = kernel_call(name, geometry)(*rays, tri_mask=mask)
  ref = kernel_call(name, geometry, plain=True)(*rays, tri_mask=mask)
  torch.cuda.synchronize()
  check(torch.equal(occ, ref), f"{name}: occlusion differs from the plain version")
  return float(occ.float().mean().item())


def work(name, geometry, rays):
  """(operations, bytes, what was counted) of one call, for its bound: the
  FP32 operations the kernel's loop needs for these rays, and each ray byte
  read once, each output byte written once and the tables read once."""
  mod, entry = KERNELS[name][:2]
  tris, bvh = geometry
  num_r = rays[0].shape[0]
  out_bytes = 16 if entry.startswith("intersect") else 1
  if mod is bvh_trace:
    fat = entry.endswith("fat")
    zeros = lambda: torch.zeros(num_r, dtype=torch.int64, device=rays[0].device)
    stats = {"boxes": 0, "tris": 0, "ray_rows": zeros(), "ray_tris": zeros()}
    getattr(bvh_trace, f"{entry}_plain")(bvh, *rays, stats=stats)
    # a ray with an empty interval needs no test (K5/K6 skip it); the rest
    # need the walk's box and triangle tests
    live = live_lanes(name, rays)
    rows = int(stats["ray_rows"][live].sum().item())
    tri_tests = int(stats["ray_tris"][live].sum().item())
    ops = rows * (2 if fat else 1) * FLOPS_PER_BOX + tri_tests * FLOPS_PER_BVH_TRI
    # the words the walk reads: a fat row but its skip word, a whole node
    # row, a triangle row but its 2 pad words; every ray's interval is read
    # and its output written, a live ray's origin and direction read
    table_bytes = bvh.fat_table.shape[0] * 60 if fat else bvh.node_table.shape[0] * 32
    n_live = int(live.sum().item())
    nbytes = (num_r * (8 + out_bytes) + n_live * 24 + table_bytes
              + bvh.prim_tris.shape[0] * 40)
    counted = {"rows" if fat else "nodes": rows, "tris": tri_tests, "live rays": n_live}
    return ops, nbytes, counted, walk_line(stats["ray_rows"], stats["ray_tris"], fat)
  live_mask = live_lanes(name, rays)
  live = int(live_mask.sum().item())
  t_tri = tris[0].shape[0]
  if entry == "intersect":
    pairs = live * t_tri
  elif mod is brute_trace:
    pairs = first_hit_pairs(*tris, *rays, live_mask)
  else:
    pairs = first_hit_pairs_chunked(mod, *tris, *rays)
  nbytes = num_r * (32 + out_bytes) + t_tri * TRI_BYTES[mod]
  return pairs * FLOPS_PER_PAIR[mod], nbytes, {"pairs": pairs, "live rays": live}, None


def walk_line(ray_rows, ray_tris, fat: bool) -> str:
  """Per-ray work of the plain walk, over every ray in index order (dead
  lanes included, as a kernel with one ray a thread walks them): mean, p99
  and max rows (nodes) and triangle tests a ray, and the share of lane
  slots that carry a step when each thread walks one ray and a warp of 32
  consecutive rays runs until its longest walk ends."""
  parts = []
  for what, x in (("fat rows" if fat else "nodes", ray_rows), ("triangle tests", ray_tris)):
    xf = x.double()
    pad = (-x.shape[0]) % 32
    warps = torch.cat([xf, xf.new_zeros(pad)]).view(-1, 32)
    share = float(xf.sum() / (32.0 * warps.amax(dim=1)).sum().clamp(min=1.0))
    parts.append(f"{what} a ray mean {float(xf.mean()):.2f} p99 {float(xf.quantile(0.99)):.0f} "
                 f"max {int(x.max())}, useful lane share {share:.3f}")
  return "; ".join(parts)


def live_lanes(name, rays):
  """(R,) bool: the rays that need work of kernel `name`, those that its
  module's skip test (`dead_lanes`) does not find dead: a dead ray has no
  valid pair (the proofs are in the kernels' sources), so it needs no test."""
  return ~KERNELS[name][0].dead_lanes(rays[2], rays[3])


def lane_variants(rays, n: int = FEW_RAYS):
  """The first n of `rays` under each lane pattern the pair-tile and BVH
  kernels must take: dead lanes (t_max = 0 or -0, which K3/K4 skip; a NaN
  t_min or a t_min one ulp above t_max, which K5/K6 skip) among live ones,
  intervals that are not empty, strided rays."""
  o, d, t_min, t_max = (x[:n] for x in rays)
  every_other = t_max.clone()
  every_other[::2] = 0.0
  one_per_warp = torch.full_like(t_max, -0.0)
  one_per_warp[::32] = t_max[::32]
  zeros = torch.zeros_like(t_min)
  nan_third = t_min.clone()
  nan_third[1::3] = float("nan")
  ulp_above = t_min.clone()
  ulp_above[::2] = torch.nextafter(t_max[::2], torch.tensor(float("inf"), device=t_max.device))
  wide = torch.cat([o, d], dim=1)
  return {"every other lane dead": (o, d, t_min, every_other),
          "all dead": (o, d, t_min, torch.zeros_like(t_max)),
          "one live ray per warp": (o, d, t_min, one_per_warp),
          "t_max == t_min": (o, d, t_min, t_min.clone()),
          "t_min = t_max = 0": (o, d, zeros, zeros.clone()),
          "NaN t_min on every third lane": (o, d, nan_third, t_max),
          "t_min one ulp above t_max on every other lane": (o, d, ulp_above, t_max),
          "strided": (wide[:, :3], wide[:, 3:], t_min, t_max)}


def compare(name, geometry, rays, mask):
  """(max abs error, hit fraction) of the kernel against its plain version."""
  if name in CLOSEST:
    return compare_intersect(name, geometry, rays, mask)
  return 0.0, compare_occluded(name, geometry, rays, mask)


def occupancy_note(name, num_t, num_r):
  """Blocks per SM and waves of a K1-K4 or K9a/K9b launch for this shape, or
  the persistent grid of K5/K6."""
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  if KERNELS[name][0] is brute_trace:
    blocks, tile = brute_trace.launch_shape(num_t, num_r, name not in CLOSEST)
    grid = -(-num_r // tile)
    return (f"{blocks} blocks of 256 threads per SM, {tile} rays a block, {grid} blocks in "
            f"{grid / (blocks * sms):.2f} waves of {blocks * sms}")
  if KERNELS[name][0] is bvh_trace:
    blocks, threads = bvh_trace.fat_occupancy(name not in CLOSEST)
    grid = min(blocks * sms, -(-num_r // threads))
    return (f"{blocks} blocks of {threads} threads per SM ({blocks * threads // 32} resident "
            f"warps), {grid} persistent blocks for {num_r} rays")
  mod = KERNELS[name][0]
  blocks = mod.occupancy(num_t, name not in CLOSEST)
  grid = -(-num_r // mod.TILE_RAYS)
  return (f"{blocks} blocks of {mod.TILE_RAYS} threads per SM, {mod.TILE_RAYS} rays a block, "
          f"{grid} blocks in {grid / (blocks * sms):.2f} waves of {blocks * sms}")


def kernel_phase(name, dev, rng, cases, timed):
  """Hold one kernel against its plain version on every case (with and
  without masked rows, and under each lane pattern of `lane_variants`: K1/K2
  on tables of at most 1,024 triangles, K9a/K9b of at most 4,096), then time
  both on each case of `timed`; the
  first timed case is the one the `kernels` line reports. A case is (label,
  (tris, bvh), origin box or None, rays)."""
  kname = KERNELS[name][2]
  mod = KERNELS[name][0]
  persistent = name in ("intersect_bvh_fat", "occluded_bvh_fat")
  err = 0.0
  for label, geometry, inside, num_r in cases:
    tris = geometry[0]
    rays = test_rays(rng, *tris, num_r, dev, inside)
    masks = (None, torch.from_numpy(rng.uniform(size=tris[0].shape[0]) > 0.25).to(dev))
    for mask in masks:
      e, frac = compare(name, geometry, rays, mask)
      err = max(err, e)
      say(name, f"{label} tris={tris[0].shape[0]} rays={num_r} masked={mask is not None} "
          f"hit fraction {frac:.4f}: matches the plain version")
      if ((mod is brute_trace and tris[0].shape[0] > BRUTE_LANE_TRIS)
          or (mod is woop_trace and tris[0].shape[0] > WOOP_LANE_TRIS)):
        continue
      fracs = []
      n_lane = BVH_LANE_RAYS if mod is bvh_trace else FEW_RAYS
      for variant, lane_rays in lane_variants(rays, n_lane).items():
        e, frac = compare(name, geometry, lane_rays, mask)
        err = max(err, e)
        fracs.append(f"{variant} {frac:.4f}")
      say(name, f"{label} masked={mask is not None} {min(n_lane, num_r)} rays under each lane "
          f"pattern match the plain version; hit fraction " + ", ".join(fracs))

  rows = []
  for label, geometry, inside, num_r in timed:
    rays = test_rays(rng, *geometry[0], num_r, dev, inside)
    run = kernel_call(name, geometry)
    plain = kernel_call(name, geometry, plain=True)
    ops, nbytes, counted, per_ray = work(name, geometry, rays)
    ms = kernel_ms(lambda: run(*rays), kname, 50)
    # one timed call after a warm one: the plain versions take up to seconds
    plain_ms = event_ms(lambda: plain(*rays), 1)
    b_ms, b_by = bound_ms(ops, nbytes)
    say(name, f"{num_r} rays x {geometry[0][0].shape[0]} tris ({label}): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by} ({ops} FP32 operations "
        f"from {counted}, {nbytes} bytes)")
    if per_ray is not None:
      say(name, f"per-ray work ({label}, plain walk): {per_ray}")
    if mod is not bvh_trace or persistent:
      say(name, occupancy_note(name, geometry[0][0].shape[0], num_r))
    rows.append({"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
  return {"max_abs_err": err, **rows[0]}


def narrow_phase(name, geometry, dev, rng, sizes=NARROW, inside=None):
  """K1, K2, K9a or K9b on narrow batches (K1/K2: the cascade's 2^12, 2^14
  and 2^16): test rays with every interval opened (t_max = 1e30 where the
  kernel's skip test found the ray dead), held against the plain version
  and timed, with the launch shape."""
  dead_lanes = KERNELS[name][0].dead_lanes
  for num_r in sizes:
    o, d, t_min, t_max = test_rays(rng, *geometry[0], num_r, dev, inside)
    rays = (o, d, t_min, torch.where(dead_lanes(t_min, t_max), 1e30, t_max))
    e, frac = compare(name, geometry, rays, None)
    run = kernel_call(name, geometry)
    ms = kernel_ms(lambda: run(*rays), KERNELS[name][2], 50)
    ops, nbytes, counted, _ = work(name, geometry, rays)
    b_ms, b_by = bound_ms(ops, nbytes)
    say(name, f"narrow batch of {num_r} live rays x {geometry[0][0].shape[0]} tris (hit "
        f"fraction {frac:.4f}): matches the plain version; kernel {ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({counted}); "
        + occupancy_note(name, geometry[0][0].shape[0], num_r))


def check_thirds(img, what):
  """Left third red-dominant, right third green-dominant."""
  third = img.shape[1] // 3
  left = img[:, :third].mean(axis=(0, 1))
  right = img[:, -third:].mean(axis=(0, 1))
  check(left[0] > left[1], f"{what}: left third not red-dominant: {left}")
  check(right[1] > right[0], f"{what}: right third not green-dominant: {right}")
  return left, right


def render_main(label, scene, config, iterations, dev):
  """One main-path render with the launch counts set to 0 just before it and
  read just after. Returns (image, counts, seconds, rays)."""
  reset_counts()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  sums, rays = path_tracing.render_samples_static(scene, config, 0, iterations,
                                                  pool_size=1 << 18, device=dev)
  fs = path_tracing.finalize_film(sums, iterations, config.film_width)
  img = film_mod.result_image(fs)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  counts = read_counts()
  rays = int(rays.item())
  say("main", f"{label}: {seconds:.3f} s, {rays} rays, {rays / seconds / 1e6:.3f} Mrays/s, "
      f"launches {counts}")
  img = img.cpu().numpy()
  check(img.shape == (config.film_height, config.film_width, 3), f"image shape {img.shape}")
  check(bool(np.isfinite(img).all()), f"{label}: image has non-finite values")
  return img, counts, seconds, rays


def main_path_cornell(scene, config, dev):
  img, counts, seconds, rays = render_main(
      f"cornell 512x512 mpl 1023 pool 2^18 {ITERATIONS} spp", scene, config, ITERATIONS, dev)
  check(bool((img >= 0.0).all()), "cornell: image has negative values")
  mean = float(img.mean())
  check(0.05 <= mean <= 0.15, f"cornell: image mean {mean} outside [0.05, 0.15]")
  left, right = check_thirds(img, "cornell")
  for key in ("intersect", "occluded"):
    check(counts[key] > 0, f"the Cornell main path never launched the {key} kernel")
  say("main", f"cornell image mean {mean:.5f}, left third RGB {left}, right third RGB {right}")
  return counts


def main_path_materials(scene, config, dev):
  check(config.spectral and config.material_classes == (0, 3, 4, 5),
        f"materials config {config}")
  img, counts, seconds, rays = render_main(
      f"materials 512x512 spectral mpl 16 pool 2^18 {MATERIALS_ITERATIONS} spp",
      scene, config, MATERIALS_ITERATIONS, dev)
  # a spectral sample's RGB may leave the gamut, but its luminance Y may not
  # be negative (beyond float rounding)
  y = img @ spectrum.RGB_TO_XYZ[1].astype(np.float64)
  check(float(y.min()) >= -1e-5 * max(1.0, float(img.max())),
        f"materials: negative luminance {y.min()}")
  mean = float(img.mean())
  lo, hi = MATERIALS_MEAN
  check(lo <= mean <= hi, f"materials: image mean {mean} outside [{lo}, {hi}]")
  left, right = check_thirds(img, "materials")
  for key in ("intersect_brute2", "occluded_brute2"):
    check(counts[key] > 0, f"the materials main path never launched the {key} kernel")
  say("main", f"materials image mean {mean:.5f}, negative-channel pixels "
      f"{float((img < 0.0).any(axis=-1).mean()):.4f}, left third RGB {left}, "
      f"right third RGB {right}")
  return counts


def main_path_bigscene(scene, config, dev):
  check(not config.spectral and config.material_classes == (0,)
        and scene.tri_v0.shape[0] == bigscene.NUM_TRIANGLES
        and scene.bvh.fat_table is not None, f"bigscene config {config}")
  img, counts, seconds, rays = render_main(
      f"bigscene 512x512 mpl 8 pool 2^18 {BIGSCENE_ITERATIONS} spp", scene, config,
      BIGSCENE_ITERATIONS, dev)
  check(bool((img >= 0.0).all()), "bigscene: image has negative values")
  mean = float(img.mean())
  lo, hi = BIGSCENE_MEAN
  check(lo <= mean <= hi, f"bigscene: image mean {mean} outside [{lo}, {hi}]")
  left, right = check_thirds(img, "bigscene")
  for key in ("intersect_bvh_fat", "occluded_bvh_fat"):
    check(counts[key] > 0, f"the bigscene main path never launched the {key} kernel")
  say("main", f"bigscene image mean {mean:.5f}, left third RGB {left}, right third RGB {right}")
  return counts


def capture_bounce(scene, config, dev, bounce: int):
  """The closest-hit and the shadow rays that the main path traces at
  `bounce` (0 = the camera rays) of one iteration, as the trace dispatch
  receives them: ((o, d, t_min, t_max), (o, d, t_min, t_max))."""
  from etx_tracer_tpu_torch.ops import trace as trace_ops
  calls = {"closest": 0, "occluded": 0}
  got = {}
  orig = {kind: getattr(trace_ops, f"trace_{kind}") for kind in calls}

  def hook(kind):
    def trace(sc, o, d, t_min, t_max, tri_mask=None):
      check(tri_mask is None, "the main path passed a triangle mask")
      if calls[kind] == bounce:
        got[kind] = tuple(x.clone() for x in (o, d, t_min, t_max))
      calls[kind] += 1
      return orig[kind](sc, o, d, t_min, t_max)
    return trace

  try:
    for kind in calls:
      setattr(trace_ops, f"trace_{kind}", hook(kind))
    path_tracing.render_samples_static(scene, config, 0, 1, pool_size=1 << 18, device=dev)
  finally:
    for kind, fn in orig.items():
      setattr(trace_ops, f"trace_{kind}", fn)
  check(set(got) == set(calls), f"the main path traced fewer than {bounce + 1} bounces")
  return got["closest"], got["occluded"]


def captured_phase(label, names, scene, config, dev):
  """The closest-hit and the any-hit kernel `names` on the rays that a main
  path traces at bounce 2: held against their plain versions, timed, with
  their live share and bound (and, for K5/K6, the plain walk's work a
  ray)."""
  closest, shadow = capture_bounce(scene, config, dev, CAPTURE_BOUNCE)
  geometry = (list(scene[:3]), scene.bvh if KERNELS[names[0]][0] is bvh_trace else None)
  for name, rays in zip(names, (closest, shadow)):
    e, frac = compare(name, geometry, rays, None)
    run = kernel_call(name, geometry)
    ms = kernel_ms(lambda: run(*rays), KERNELS[name][2], 50)
    ops, nbytes, counted, per_ray = work(name, geometry, rays)
    b_ms, b_by = bound_ms(ops, nbytes)
    live = live_lanes(name, rays)
    dead_zero = float((~live & (rays[3] == 0.0)).float().mean().item())
    say("captured", f"{name} on the {label} main path's bounce {CAPTURE_BOUNCE} "
        f"({rays[0].shape[0]} lanes, live share {float(live.float().mean().item()):.4f}, dead "
        f"with t_max = 0 {dead_zero:.4f}, hit fraction {frac:.4f}): matches the plain version "
        f"(max abs err {e}); kernel {ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({ops} FP32 "
        f"operations from {counted}, {nbytes} bytes)")
    if per_ray is not None:
      say("captured", f"{name} per-ray work (plain walk): {per_ray}")


def profile_step_mix(label, scene, config, dev):
  """Where a main-path bounce spends its time: one iteration under the
  profiler. Prints kernels launched per bounce, the device's busy share of
  the wall time and the kernels that take most of the device time."""
  from torch.profiler import ProfilerActivity, profile
  reset_counts()
  path_tracing.render_samples_static(scene, config, 0, 1, pool_size=1 << 18, device=dev)
  torch.cuda.synchronize()
  steps = sum(read_counts()[k] for k in CLOSEST)
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    path_tracing.render_samples_static(scene, config, 0, 1, pool_size=1 << 18, device=dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  busy_us, launched, by_name = 0.0, 0, []
  for ev in prof.key_averages():
    t = ev.self_device_time_total
    if t > 0.0:
      busy_us += t
      launched += ev.count
      by_name.append((t, ev.count, ev.key))
  by_name.sort(reverse=True)
  check(busy_us > 0.0, "the profiler recorded no device time")
  say("profile", f"{label} 1 spp: {steps} bounces, {wall_ms:.1f} ms wall, device busy "
      f"{busy_us / 1e3:.1f} ms ({busy_us / 1e3 / wall_ms:.3f} of wall), "
      f"{launched / max(steps, 1):.0f} kernels per bounce")
  for t, count, key in by_name[:6]:
    say("profile", f"  {t / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
  names = {entry[2] for entry in KERNELS.values()}
  for t, count, key in by_name:
    if any(n in key for n in names):
      say("profile", f"  trace kernel {key[:60]}: {count} launches, "
          f"{t / 1e3 / count:.4f} ms per launch")


def render_small(build, dev_name: str, iterations: int):
  scene, config = build(dev_name)
  img = film_mod.result_image(path_tracing.render(scene, config, iterations=iterations,
                                                  device=dev_name))
  return img.cpu().numpy()


def card_vs_cpu(label, build, iterations):
  card = render_small(build, "cuda", iterations)
  cpu = render_small(build, "cpu", iterations)
  out = np.abs(card - cpu) > 1e-4 + 1e-3 * np.abs(cpu)
  frac = float(out.any(axis=-1).mean())
  mean_rel = float(abs(card.mean(dtype=np.float64) - cpu.mean(dtype=np.float64))
                   / abs(cpu.mean(dtype=np.float64)))
  say("e2e", f"{label}, card vs CPU: outlier pixels {frac:.4f}, mean rel diff {mean_rel:.2e}, "
      f"max abs diff {float(np.abs(card - cpu).max()):.3e}, CPU mean {float(cpu.mean()):.5f}")
  check(frac <= E2E_OUTLIERS, f"{label} card vs CPU: {frac} of pixels differ")
  check(mean_rel <= E2E_MEAN_RTOL, f"{label} card vs CPU: image means differ by {mean_rel}")
  return card


def end_to_end():
  """The 32x32 renders on the card against the same renders on the CPU.
  Returns the launch counts of the bigscene render through K7/K8."""
  card = card_vs_cpu("cornell 32x32 golden config", lambda d: cornell_scene((32, 32), 6, d), 4)
  mean = card.mean(axis=(0, 1))
  total = float(card.sum())
  check(np.allclose(mean, GOLDEN_MEAN, rtol=GOLDEN_RTOL, atol=1e-5),
        f"card mean {mean} vs golden {GOLDEN_MEAN}")
  check(abs(total - GOLDEN_TOTAL) <= GOLDEN_RTOL * GOLDEN_TOTAL,
        f"card total {total} vs golden {GOLDEN_TOTAL}")
  say("e2e", f"card mean {mean}, total {total:.4f}: within rtol {GOLDEN_RTOL} of the golden values")
  card_vs_cpu("materials 32x32 spectral 4 spp", lambda d: materials_scene((32, 32), d), 4)

  reset_counts()
  card_vs_cpu("bigscene 32x32 8 spp (K5/K6)", lambda d: bigscene_scene((32, 32), d), 8)
  counts = read_counts()
  for key in ("intersect_bvh_fat", "occluded_bvh_fat"):
    check(counts[key] > 0, f"the bigscene 32x32 render never launched the {key} kernel")
  reset_counts()
  card_vs_cpu("bigscene 32x32 8 spp without fat rows (K7/K8)",
              lambda d: bigscene_scene((32, 32), d, fat_rows=False), 8)
  counts = read_counts()
  say("e2e", f"bigscene without fat rows: launches {counts}")
  for key in ("intersect_bvh", "occluded_bvh"):
    check(counts[key] > 0, f"the bigscene render without fat rows never launched the {key} kernel")
  check(counts["intersect_bvh_fat"] == 0 and counts["occluded_bvh_fat"] == 0,
        "the bigscene render without fat rows launched a fat-row kernel")
  return counts


def micro_phase(dev):
  """The micro-benchmark entry's four trace groups at full width, each with
  the launch counts set to 0 just before it and read just after; checks
  that every line went through its kernels and that the kernels agree:
  K5 and K1 give equal t (one triangle test), the sorted and oracle orders
  give each ray the unsorted hit, and K9a agrees with K3. Returns the
  launch counts of `trace_brute`, the path that runs K9a/K9b."""
  wants = {"trace": ("intersect_bvh_fat", "intersect"),
           "trace_brute": ("intersect_brute2", "occluded_brute2", "intersect_woop",
                           "occluded_woop"),
           "trace_sorted": ("intersect_bvh_fat",), "trace_oracle": ("intersect_bvh_fat",)}
  lines, counts = {}, {}
  for group, want in wants.items():
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = micro.run(group, dev)
    torch.cuda.synchronize()
    counts[group] = read_counts()
    launched = {k: n for k, n in counts[group].items() if n}
    say("micro", f"{group}: {len(out)} lines in {time.perf_counter() - t0:.1f} s, "
        f"launches {launched}")
    check(set(launched) == set(want), f"micro {group} launched {launched}, not {want}")
    check(all(np.isfinite(x.seconds) and x.seconds > 0.0 for x in out),
          f"micro {group}: a step time is not a positive number")
    lines[group] = {x.label: x for x in out}

  big = micro.scene("bigscene", str(dev))
  for kind in ("primary", "bounce", "random"):
    fat, brute = (lines["trace"][f"{k} {kind}"].result for k in ("fat", "brute"))
    check(torch.equal(fat.t, brute.t), f"micro trace {kind}: K5 and K1 give other t")
    # the kernels' device time per launch on the group's rays, by CUDA
    # events around back-to-back calls (one launch a call, no chained ops)
    rays = micro._rays(big, micro.SIZES["trace"], kind, dev)
    k5_ms = event_ms(lambda: bvh_trace.intersect_fat(big.bvh, *rays), 20)
    k1_ms = event_ms(lambda: brute_trace.intersect(*big[:3], *rays), 5)
    say("micro", f"trace {kind}: K5 {k5_ms:.4f} ms and K1 {k1_ms:.4f} ms per call (events); "
        f"equal t, equal tri {(fat.tri == brute.tri).float().mean().item():.5f}, hit fraction "
        f"{fat.found.float().mean().item():.4f}")
  for kind in ("bounce", "random"):
    o, d, t_min, t_max = micro._rays(big, micro.SIZES["trace_sorted"], kind, dev)
    want = bvh_trace.intersect_fat(big.bvh, o, d, t_min, t_max)
    got = lines["trace_sorted"][f"fat+sort {kind}"].result
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"micro trace_sorted {kind}: the sorted trace gives other hits")
    for name, key in micro.oracle_keys(big.bvh, o, d, want):
      perm = torch.argsort(key, stable=True)
      got = lines["trace_oracle"][f"oracle[{name}] {kind}"].result
      check(all(torch.equal(a, b[perm]) for a, b in zip(got, want)),
            f"micro trace_oracle[{name}] {kind}: the sorted rays give other hits")
  for name in micro.SCENES:
    k3, k9 = (lines["trace_brute"][f"{name} {k} closest"].result for k in ("brute2", "woop"))
    o3, o9 = (lines["trace_brute"][f"{name} {k} anyhit"].result for k in ("brute2", "woop"))
    same = k3.tri == k9.tri
    both = same & k3.found
    rel = ((k9.t - k3.t).abs() / k3.t.abs())[both]
    max_rel = rel.max().item() if rel.numel() else 0.0
    close = (rel <= 1e-4).float().mean().item() if rel.numel() else 1.0
    share = same.float().mean().item()
    say("micro", f"trace_brute {name}: K9a vs K3 equal tri {share:.6f} "
        f"({int((~same).sum())} of {same.numel()} rays differ), largest relative |dt| "
        f"{max_rel:.3e} where equal ({close:.6f} of them within 1e-4); K9b vs K4 equal "
        f"{(o3 == o9).float().mean().item():.6f}; hit fraction "
        f"{k3.found.float().mean().item():.4f}")
    # two formulations of one test: they part only at edges, ties and
    # grazing angles, where t = -w_z / q_z divides by a small cosine
    check(share >= 0.99 and close >= 0.999,
          f"trace_brute {name}: K9a and K3 disagree (equal tri {share}, t within 1e-4 {close})")
  return counts["trace_brute"]


def woop_matmul_note(dev):
  """For comparison only (the port never calls it): one FP32 `torch.matmul`
  of the (R, 8) x (8, 6 x 512) product per 512-triangle chunk, the part of
  K9a that the TPU kernel hands to its matrix unit, at 2^18 rays, TF32 off."""
  torch.backends.cuda.matmul.allow_tf32 = False
  ray8 = torch.randn(RAYS, 8, device=dev)
  chunk = torch.randn(8, 6 * woop_trace.CHUNK, device=dev)
  out = torch.empty(RAYS, 6 * woop_trace.CHUNK, device=dev)
  for name, num_t in (("materials", 996), ("bigscene", bigscene.NUM_TRIANGLES)):
    chunks = -(-num_t // woop_trace.CHUNK)

    def product():
      for _ in range(chunks):
        torch.matmul(ray8, chunk, out=out)

    ms = event_ms(product, 3)
    say("woop_matmul", f"{name}: {chunks} x FP32 matmul (2^18, 8) x (8, {6 * woop_trace.CHUNK}) "
        f"{ms:.4f} ms (TF32 off)")


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
    return 2
  dev = torch.device("cuda")
  kind = torch.cuda.get_device_name(0)

  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
  card_line = smi.stdout.strip().splitlines()[0]
  say("device", f"{card_line} ({kind}, torch {torch.__version__}, CUDA {torch.version.cuda})")

  t0 = time.perf_counter()
  built = _build.build_all()
  say("build", f"{len(built)} source(s) built in {time.perf_counter() - t0:.2f} s")
  for name, (seconds, log) in built.items():
    usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    say("build", f"{name}: nvcc {seconds:.2f} s; " + " | ".join(usage))

  rng = np.random.default_rng(20261017)
  cornell_512 = cornell_scene((512, 512), 1023, dev)
  materials_512 = materials_scene((512, 512), dev)
  bigscene_512 = bigscene_scene((512, 512), dev)
  caustics_scene = caustics.build_caustics_scene((512, 512)).build(device=dev)[0]
  cornell_geo = (list(cornell_512[0][:3]), None)
  mat_geo = (list(materials_512[0][:3]), None)
  big_geo = (list(bigscene_512[0][:3]), bigscene_512[0].bvh)
  caustics_geo = (list(caustics_scene[:3]), None)
  # cases: (label, geometry, origin box, rays); the dispatch thresholds are
  # 128 (K1/K2) and 4096 (K3/K4) triangles, the kernels take any count
  small = [("cornell", cornell_geo, None, RAYS),
           ("soup128", (tri_soup(rng, 128, dev), None), None, RAYS),
           ("materials", mat_geo, ROOM, FEW_RAYS),
           ("bigscene", big_geo, ROOM, FEW_RAYS)]
  soup4096 = ("soup4096", (tri_soup(rng, 4096, dev), None), None, RAYS)
  soup129 = ("soup129", (tri_soup(rng, 129, dev), None), None, RAYS)
  soup4097 = ("soup4097", (tri_soup(rng, 4097, dev), None), None, RAYS)
  pair_tile = [("materials", mat_geo, ROOM, RAYS), soup4096, soup4097, soup129,
               ("cornell", cornell_geo, None, RAYS), ("bigscene", big_geo, ROOM, RAYS)]
  woop = [("materials", mat_geo, ROOM, RAYS), ("caustics", caustics_geo, ROOM, RAYS),
          ("bigscene", big_geo, ROOM, RAYS), soup4096, soup129]
  soup = soup_tree(rng, 5000, dev)
  comb = comb_tree(rng, 61, dev)
  bvh_fat = [("bigscene", big_geo, ROOM, RAYS), ("soup5000", soup, None, RAYS),
             ("comb61", comb, None, FEW_RAYS)]
  bvh_node = [(label, (tris, scene_types.without_fat_rows(bvh)), box, num_r)
              for label, (tris, bvh), box, num_r in bvh_fat]
  # K1, K3 and K9a timed also at bigscene's 15,396 triangles, at the micro
  # groups' ray counts (K1: `trace`, 2^16; K3 and K9a: `trace_brute`, 2^18)
  big_k1 = ("bigscene", big_geo, ROOM, 1 << 16)
  results = {
      "intersect": kernel_phase("intersect", dev, rng, small, [small[0], big_k1]),
      "occluded": kernel_phase("occluded", dev, rng, small, small[:1]),
  }
  # a generator of its own, so the later phases draw the rays they drew before
  narrow_rng = np.random.default_rng(20261018)
  for name in ("intersect", "occluded"):
    narrow_phase(name, cornell_geo, dev, narrow_rng)
  results |= {
      "intersect_brute2": kernel_phase("intersect_brute2", dev, rng, pair_tile,
                                       [pair_tile[0], pair_tile[-1]]),
      "occluded_brute2": kernel_phase("occluded_brute2", dev, rng, pair_tile, pair_tile[:1]),
      "intersect_bvh_fat": kernel_phase("intersect_bvh_fat", dev, rng, bvh_fat, bvh_fat[:1]),
      "occluded_bvh_fat": kernel_phase("occluded_bvh_fat", dev, rng, bvh_fat, bvh_fat[:1]),
      "intersect_bvh": kernel_phase("intersect_bvh", dev, rng, bvh_node, bvh_node[:1]),
      "occluded_bvh": kernel_phase("occluded_bvh", dev, rng, bvh_node, bvh_node[:1]),
      "intersect_woop": kernel_phase("intersect_woop", dev, rng, woop, [woop[0], woop[2]]),
      "occluded_woop": kernel_phase("occluded_woop", dev, rng, woop, woop[:1]),
  }
  for name in ("intersect_woop", "occluded_woop"):
    narrow_phase(name, mat_geo, dev, narrow_rng, WOOP_NARROW, ROOM)
  woop_matmul_note(dev)

  counts = main_path_cornell(*cornell_512, dev)
  profile_step_mix("cornell 512x512", *cornell_512, dev)
  captured_phase("cornell", ("intersect", "occluded"), *cornell_512, dev)
  counts_mat = main_path_materials(*materials_512, dev)
  profile_step_mix("materials 512x512", *materials_512, dev)
  captured_phase("materials", ("intersect_brute2", "occluded_brute2"), *materials_512, dev)
  counts_big = main_path_bigscene(*bigscene_512, dev)
  profile_step_mix("bigscene 512x512", *bigscene_512, dev)
  captured_phase("bigscene", ("intersect_bvh_fat", "occluded_bvh_fat"), *bigscene_512, dev)
  counts_node = end_to_end()
  counts_micro = micro_phase(dev)

  launches = {"intersect": counts["intersect"], "occluded": counts["occluded"],
              "intersect_brute2": counts_mat["intersect_brute2"],
              "occluded_brute2": counts_mat["occluded_brute2"],
              "intersect_bvh_fat": counts_big["intersect_bvh_fat"],
              "occluded_bvh_fat": counts_big["occluded_bvh_fat"],
              "intersect_bvh": counts_node["intersect_bvh"],
              "occluded_bvh": counts_node["occluded_bvh"],
              "intersect_woop": counts_micro["intersect_woop"],
              "occluded_woop": counts_micro["occluded_woop"]}
  kernels = []
  for name, r in results.items():
    _, _, _, replaces, source = KERNELS[name]
    kernels.append({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None})
  print(card_line, flush=True)
  print(json.dumps({"kernels": kernels}), flush=True)
  # one card: the run uses cuda:0 and nothing else
  print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}),
        flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
