"""Batched ray-scene intersection: dispatch by scene size.

Counterpart of `etx_tracer_tpu/ops/trace.py`, with its thresholds:

- at most 128 triangles (the JAX package's unroll limit): the brute-force
  kernels of `ops/brute_trace.py`, closest hit K1 and occlusion K2;
- 129 to 4096 triangles: the pair-tile kernels of `ops/brute2_trace.py`,
  closest hit K3 and occlusion K4;
- more: the BVH kernels of `ops/bvh_trace.py`, over the fat rows (K5/K6)
  when the scene's tree has them, else over the plain nodes (K7/K8).

The JAX package falls back to its per-ray-stack XLA traversal when a scene
has 2^24 or more triangles or nodes, because its TPU tables carry ids as
float32; the port's tables carry int32 ids, so that fallback does not apply.

Nothing falls back to a plain version on a CUDA tensor: each wrapper
launches its kernel there and runs its plain version only on the CPU.
"""

from __future__ import annotations

import functools

import torch

from etx_tracer_tpu_torch.ops import brute2_trace, brute_trace, bvh_trace
from etx_tracer_tpu_torch.ops.brute_trace import Hit  # noqa: F401  (re-export)

# the plain closest-hit loop, the semantics reference (JAX: intersect_scan)
intersect_scan = brute_trace.intersect_plain


def _route(scene):
  """(closest, occluded) for the scene's size, each bound to its geometry
  and taking (o, d, t_min, t_max, tri_mask)."""
  num_t = scene.tri_v0.shape[0]
  if num_t <= brute2_trace.MAX_TRIS:
    mod = brute_trace if num_t <= brute_trace.MAX_TRIS else brute2_trace
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
