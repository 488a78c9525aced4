"""Batched ray-scene intersection: dispatch by scene size.

Counterpart of `etx_tracer_tpu/ops/trace.py`, with its thresholds:

- at most 128 triangles (the JAX package's unroll limit): the brute-force
  kernels of `ops/brute_trace.py`, closest hit K1 and occlusion K2;
- 129 to 4096 triangles: the pair-tile kernels of `ops/brute2_trace.py`,
  closest hit K3 and occlusion K4;
- more: the BVH kernels of a later slice, so this raises.

Nothing falls back to a plain version on a CUDA tensor: each wrapper
launches its kernel there and runs its plain version only on the CPU.
"""

from __future__ import annotations

import torch

from etx_tracer_tpu_torch.ops import brute2_trace, brute_trace
from etx_tracer_tpu_torch.ops.brute_trace import Hit  # noqa: F401  (re-export)

# the plain closest-hit loop, the semantics reference (JAX: intersect_scan)
intersect_scan = brute_trace.intersect_plain


def _kernels(scene):
  """The kernel module for the scene's triangle count."""
  num_t = scene.tri_v0.shape[0]
  if num_t <= brute_trace.MAX_TRIS:
    return brute_trace
  if num_t <= brute2_trace.MAX_TRIS:
    return brute2_trace
  raise NotImplementedError(f"{num_t} triangles: BVH kernels: later slice")


def trace_closest(scene, o, d, t_min, t_max, tri_mask=None) -> Hit:
  """Closest hit of each ray against the scene."""
  return _kernels(scene).intersect(scene.tri_v0, scene.tri_e1, scene.tri_e2,
                                   o, d, t_min, t_max, tri_mask)


def trace_occluded(scene, o, d, t_min, t_max, tri_mask=None) -> torch.Tensor:
  """Boolean occlusion of each shadow ray within [t_min, t_max]."""
  return _kernels(scene).occluded(scene.tri_v0, scene.tri_e1, scene.tri_e2,
                                  o, d, t_min, t_max, tri_mask)
