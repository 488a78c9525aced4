"""Batched ray-scene intersection: dispatch by scene size.

Counterpart of `etx_tracer_tpu/ops/trace.py`, with its thresholds (the
kernels themselves take any triangle count):

- at most `_UNROLL_LIMIT` = 128 triangles: the brute-force kernels of
  `ops/brute_trace.py`, closest hit K1 and occlusion K2;
- up to `_BVH_PALLAS_MIN_TRIS` = 4096 triangles: the pair-tile kernels of
  `ops/brute2_trace.py`, closest hit K3 and occlusion K4;
- more: the BVH kernels of `ops/bvh_trace.py`, over the fat rows (K5/K6)
  when the scene's tree has them, else over the plain nodes (K7/K8).

The JAX package falls back to its per-ray-stack XLA traversal when a scene
has 2^24 or more triangles or nodes, because its TPU tables carry ids as
float32; the port's tables carry int32 ids, so that fallback does not apply.

Nothing falls back to a plain version on a CUDA tensor: each wrapper
launches its kernel there and runs its plain version only on the CPU.

`_ray_sort_keys` and `_sorted_for_trace` are the JAX module's Morton ray
sort, which its dispatch does not use (measured a net loss there); the
micro-benchmark (`benchmarks/micro.py`) sorts rays with them.
"""

from __future__ import annotations

import functools

import torch

from etx_tracer_tpu_torch.ops import brute2_trace, brute_trace, bvh_trace, woop_trace
from etx_tracer_tpu_torch.ops.brute_trace import Hit  # noqa: F401  (re-export)

# the plain closest-hit loop, the semantics reference (JAX: intersect_scan)
intersect_scan = brute_trace.intersect_plain

# the JAX package's dispatch thresholds: K1/K2 up to its unroll limit
# (`pallas_trace._UNROLL_LIMIT`), K3/K4 up to `trace._BVH_PALLAS_MIN_TRIS`
_UNROLL_LIMIT = 128
_BVH_PALLAS_MIN_TRIS = 4096


def _route(scene):
  """(closest, occluded) for the scene's size, each bound to its geometry
  and taking (o, d, t_min, t_max, tri_mask)."""
  num_t = scene.tri_v0.shape[0]
  if num_t <= _BVH_PALLAS_MIN_TRIS:
    mod = brute_trace if num_t <= _UNROLL_LIMIT else brute2_trace
    tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
    return (functools.partial(mod.intersect, *tris), functools.partial(mod.occluded, *tris))
  if scene.bvh is None:
    raise ValueError(f"{num_t} triangles and no BVH: the BVH kernels need the scene's "
                     "tree (scene/builder.py builds it)")
  if scene.bvh.fat_table is not None:
    fns = (bvh_trace.intersect_fat, bvh_trace.occluded_fat)
  else:
    fns = (bvh_trace.intersect_node, bvh_trace.occluded_node)
  return tuple(functools.partial(fn, scene.bvh) for fn in fns)


def trace_closest(scene, o, d, t_min, t_max, tri_mask=None) -> Hit:
  """Closest hit of each ray against the scene."""
  return _route(scene)[0](o, d, t_min, t_max, tri_mask)


def trace_occluded(scene, o, d, t_min, t_max, tri_mask=None) -> torch.Tensor:
  """Boolean occlusion of each shadow ray within [t_min, t_max]."""
  return _route(scene)[1](o, d, t_min, t_max, tri_mask)


def _spread3(x):
  """Spread 10 bits to every third bit (Morton interleave), in int64."""
  x = (x | (x << 16)) & 0x030000FF
  x = (x | (x << 8)) & 0x0300F00F
  x = (x | (x << 4)) & 0x030C30C3
  x = (x | (x << 2)) & 0x09249249
  return x


def _root_box(bvh):
  """(min, max) of the tree's root box, float32 (3,) each."""
  box = bvh.node_table[0, 0:6].contiguous().view(torch.float32)
  return box[0:3], box[3:6]


def _morton(bvh, p):
  """27-bit Morton code (9 bits an axis, int64) of the cell of each point
  (R, 3) in the tree's root box, points outside clamped to it."""
  root_min, root_max = _root_box(bvh)
  root_ext = torch.clamp(root_max - root_min, min=1e-6)
  q = torch.clamp((p - root_min) / root_ext, 0.0, 1.0)
  cell = (q * 511.0).to(torch.int64)
  return _spread3(cell[:, 0]) | (_spread3(cell[:, 1]) << 1) | (_spread3(cell[:, 2]) << 2)


def launch_counts() -> dict:
  """The trace kernels' launch counters in this process, by
  "module.kernel" ("brute_trace.intersect", ...)."""
  return {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": n
          for mod in (brute_trace, brute2_trace, bvh_trace, woop_trace)
          for name, n in mod.launches.items()}


def _ray_sort_keys(bvh, o, d):
  """Spatial-major sort keys: the Morton code of the origin with the 3-bit
  direction octant minor, as int64 (30 bits, the JAX package's uint32
  values)."""
  octant = ((d[:, 0] >= 0).to(torch.int64) | ((d[:, 1] >= 0).to(torch.int64) << 1)
            | ((d[:, 2] >= 0).to(torch.int64) << 2))
  return (_morton(bvh, o) << 3) | octant


def _sorted_for_trace(bvh, o, d, t_min, t_max):
  """Morton-sorted rays and the inverse permutation: ((o, d, t_min, t_max)
  sorted, inv), with x_sorted[inv] == x. The sort is stable, as
  `jnp.argsort`, so equal keys keep their order."""
  perm = torch.argsort(_ray_sort_keys(bvh, o, d), stable=True)
  inv = torch.empty_like(perm)
  inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
  return (o[perm], d[perm], t_min[perm], t_max[perm]), inv
