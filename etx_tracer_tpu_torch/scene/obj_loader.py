"""Density-grid files for heterogeneous media.

Counterpart of `_load_density_grid` in `etx_tracer_tpu/scene/obj_loader.py`
(the rest of that module, the OBJ/MTL scene loader, is a later slice).
"""

from __future__ import annotations

import os
import struct

import numpy as np


def load_density_grid(path: str):
  """A (gz, gy, gx) density array from a Mitsuba `.vol` dense grid (float32
  voxels, z-y-x order, the first channel) or a `.npy` array; None when the
  file is missing or not a float32 `.vol`. Grids are normalised to a
  maximum of 1 when a scene is built, not here. NanoVDB (`.nvdb`) grids
  raise NotImplementedError."""
  if path.endswith(".nvdb") or path.endswith(".nvdb.gz"):
    raise NotImplementedError(
        f"{path}: NanoVDB grids come with the loaders' slice (ROADMAP Queue 1 item 12)")
  if not os.path.isfile(path):
    return None
  if path.endswith(".npy"):
    return np.load(path)
  if path.endswith(".vol"):
    with open(path, "rb") as f:
      data = f.read()
    if data[:3] != b"VOL":
      return None
    enc, rx, ry, rz, ch = struct.unpack("<iiiii", data[4:24])
    if enc != 1:  # float32 only
      return None
    vals = np.frombuffer(data[48:48 + 4 * rx * ry * rz * ch], "<f4")
    return np.ascontiguousarray(vals.reshape(rz, ry, rx, ch)[..., 0])
  return None
