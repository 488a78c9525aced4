"""Scene tables and film state carried across from the JAX package, as
numpy arrays.

Tests feed both packages the identical scene: they flatten the JAX
`DeviceScene` into numpy arrays keyed by dotted field path and hand those,
with the JAX `SceneConfig`'s fields, to `from_numpy`; the JAX `FilmSums`
table and `FilmState` layers go across the same way (`film_sums_from_numpy`,
`film_state_from_numpy`), so both packages start a pass from the same sums
or the same film. This module takes
numpy arrays and plain values only, never a JAX object, and the port's own
render path does not use it: it builds its scenes with `scene/builder.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from etx_tracer_tpu_torch import resolve_device
from etx_tracer_tpu_torch.ops import bvh_build
from etx_tracer_tpu_torch.scene import types as st

def check_supported(config_fields) -> None:
  """Raise ValueError if a configuration names a pixel filter the port does
  not know. Every other JAX SceneConfig field and value is ported (the
  validating build since the utilities' slice)."""
  if config_fields.get("pixel_filter", "blackman-harris") not in ("blackman-harris", "box", "center"):
    raise ValueError(f"unknown pixel_filter {config_fields['pixel_filter']!r}")


def from_numpy(arrays, config_fields, device=None):
  """(DeviceScene, SceneConfig) from numpy arrays keyed by dotted field path
  ("tri_v0", "camera.position", "emitters.env_indices", "images.col_ap",
  ...) and a mapping of SceneConfig field values, the tree in the JAX
  layout ("bvh.node_min", ...). The arrays, with the BVH kernels' tables
  built from the tree, are copied onto `device` (default: the CUDA card,
  which must exist); the JAX bank's fields that the port does not read
  (the CDF stand-ins, `inv_size`) are dropped."""
  device = resolve_device(device)
  check_supported(config_fields)
  names = {f.name for f in dataclasses.fields(st.SceneConfig)}
  config = st.SceneConfig(**{k: v for k, v in config_fields.items() if k in names})
  arrays = {**arrays, **bvh_build.kernel_tables(arrays)}
  return st.scene_from_arrays(arrays, device), config


def film_sums_from_numpy(table, device=None):
  """A `models.path_tracing.FilmSums` from a (H*W, 14) array (the JAX
  `FilmSums.table`), as float32 on `device` (default: the CUDA card)."""
  from etx_tracer_tpu_torch.models.path_tracing import FilmSums
  return FilmSums(torch.as_tensor(np.array(table, np.float32), device=resolve_device(device)))


def film_state_from_numpy(layers, device=None):
  """A `render.film.FilmState` from a mapping of its field names to arrays
  (the JAX `FilmState._asdict()`): the (H,W,3) layers as float32, the
  iteration count as int32, on `device` (default: the CUDA card)."""
  from etx_tracer_tpu_torch.render.film import FilmState
  device = resolve_device(device)
  return FilmState(**{
      name: torch.as_tensor(np.array(layers[name],
                                       np.int32 if name == "iteration" else np.float32),
                            device=device)
      for name in FilmState._fields})
