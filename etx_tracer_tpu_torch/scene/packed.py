"""Packed row tables: one float row per material, triangle, emitter and
emitter profile.

Counterpart of `etx_tracer_tpu/scene/packed.py`, with the same layouts. The
JAX package packs records so that a one-hot matmul fetches a whole record at
once on the TPU; here a row is fetched by plain indexing (`table[idx]`),
which is exact, as the JAX package's HIGHEST-precision one-hot gather is.
Tables are built with numpy on the host; the row views read torch tensors.
Integer fields ride as exact small floats and are cast back on read.
"""

from __future__ import annotations

import numpy as np
import torch

# (field, width, is_int) in Materials order
MAT_LAYOUT = [
    ("cls", 1, True), ("reflectance_spec", 1, True), ("reflectance_img", 1, True),
    ("scattering_spec", 1, True), ("scattering_img", 1, True),
    ("roughness", 2, False), ("roughness_img", 1, True),
    ("metalness", 1, False), ("metalness_img", 1, True),
    ("transmission", 1, False), ("transmission_img", 1, True),
    ("int_ior_eta", 1, True), ("int_ior_k", 1, True), ("int_ior_cls", 1, True),
    ("ext_ior_eta", 1, True), ("ext_ior_k", 1, True),
    ("int_medium", 1, True), ("ext_medium", 1, True),
    ("normal_img", 1, True), ("normal_scale", 1, False),
    ("two_sided", 1, True), ("opacity", 1, False),
    ("emission_collimation", 1, False), ("diffuse_variation", 1, True),
    ("subsurface_cls", 1, True), ("subsurface_spec", 1, True),
    ("thinfilm_eta", 1, True), ("thinfilm_k", 1, True), ("thinfilm_img", 1, True),
    ("thinfilm_min", 1, False), ("thinfilm_max", 1, False),
]


def _mat_columns():
  out, ofs = {}, 0
  for name, width, is_int in MAT_LAYOUT:
    out[name] = (ofs, width, is_int)
    ofs += width
  return out


_MAT_COLUMNS = _mat_columns()


def mat_column(name: str) -> int:
  return _MAT_COLUMNS[name][0]


# the image columns of MAT_LAYOUT
MATERIAL_IMAGE_COLUMNS = ("reflectance_img", "scattering_img", "roughness_img",
                          "metalness_img", "transmission_img", "normal_img", "thinfilm_img")


def material_features(mat_table: np.ndarray) -> tuple:
  """Host facts about a packed material table (numpy, one row a
  material), fixed when a scene is frozen: the image columns that hold an
  image index in some row, then "thinfilm" where some material has a thin
  film (thinfilm_min x thinfilm_max > 0). They gate the texture lookups
  (`render/images.py`) and the thin-film Fresnel (`render/bsdf/lobes.py`),
  which then launch nothing for a scene without them."""
  table = np.asarray(mat_table)
  out = tuple(c for c in MATERIAL_IMAGE_COLUMNS if (table[:, mat_column(c)] >= 0).any())
  if (table[:, mat_column("thinfilm_min")] * table[:, mat_column("thinfilm_max")] > 0.0).any():
    out += ("thinfilm",)
  return out


def pack_materials(materials) -> np.ndarray:
  """materials: mapping field -> (M,) or (M,2) array, in MAT_LAYOUT's fields."""
  cols = []
  for name, _, _ in MAT_LAYOUT:
    v = np.asarray(materials[name]).astype(np.float32)
    cols.append(v if v.ndim == 2 else v[:, None])
  return np.concatenate(cols, axis=1)


class MaterialRows:
  """View over gathered mat_table rows; a field is sliced (and cast back to
  int32 for integer fields) when it is read."""

  def __init__(self, rows: torch.Tensor):
    self._rows = rows

  def __getattr__(self, name):
    try:
      ofs, width, is_int = _MAT_COLUMNS[name]
    except KeyError:
      raise AttributeError(name) from None
    v = self._rows[:, ofs] if width == 1 else self._rows[:, ofs:ofs + width]
    return v.to(torch.int32) if is_int else v

  def with_column(self, name: str, value) -> "MaterialRows":
    """A copy of the rows with the one-wide field `name` set to `value`."""
    rows = self._rows.clone()
    rows[:, _MAT_COLUMNS[name][0]] = value
    return MaterialRows(rows)


def unpack_material_rows(rows: torch.Tensor) -> MaterialRows:
  """Per-lane material rows (R, 32) as their named columns (the JAX
  package's `unpack_material_rows` gives a NamedTuple of arrays; here the
  columns are views read by name from `MaterialRows`)."""
  return MaterialRows(rows)


def build_tri_table(pos, nrm, tan, btn, uv, idx, geo_n, mat, emitter, area) -> np.ndarray:
  """Per-triangle shading record:
  [geo_n(3), mat, emitter, area, n0 n1 n2 (9), t0 t1 t2 (9), b0 b1 b2 (9),
   uv0 uv1 uv2 (6)] = 39 floats. Positions interpolate from tri_v0/e1/e2.
  """
  i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
  return np.concatenate([
      geo_n, mat[:, None].astype(np.float32), emitter[:, None].astype(np.float32),
      area[:, None],
      nrm[i0], nrm[i1], nrm[i2],
      tan[i0], tan[i1], tan[i2],
      btn[i0], btn[i1], btn[i2],
      uv[i0], uv[i1], uv[i2],
  ], axis=1).astype(np.float32)


class TriRows:
  """View over gathered tri_table rows."""

  def __init__(self, rows: torch.Tensor):
    self.geo_n = rows[:, 0:3]
    self.mat = rows[:, 3].to(torch.int32)
    self.emitter = rows[:, 4].to(torch.int32)
    self.area = rows[:, 5]
    self.n0 = rows[:, 6:9]
    self.n1 = rows[:, 9:12]
    self.n2 = rows[:, 12:15]
    self.t0 = rows[:, 15:18]
    self.t1 = rows[:, 18:21]
    self.t2 = rows[:, 21:24]
    self.b0 = rows[:, 24:27]
    self.b1 = rows[:, 27:30]
    self.b2 = rows[:, 30:33]
    self.uv0 = rows[:, 33:35]
    self.uv1 = rows[:, 35:37]
    self.uv2 = rows[:, 37:39]


def build_emitter_table(cls, profile, triangle, weight, triangle_area, pdf) -> np.ndarray:
  """[cls, profile, triangle, weight, area, pdf] per instance."""
  return np.stack([np.asarray(a).astype(np.float32)
                   for a in (cls, profile, triangle, weight, triangle_area, pdf)], axis=1)


class EmitterRows:
  def __init__(self, rows: torch.Tensor):
    self.cls = rows[:, 0].to(torch.int32)
    self.profile = rows[:, 1].to(torch.int32)
    self.triangle = rows[:, 2].to(torch.int32)
    self.weight = rows[:, 3]
    self.triangle_area = rows[:, 4]
    self.pdf = rows[:, 5]


def build_profile_table(cls, emission_spec, emission_img, direction, angular_size,
                        equivalent_disk_size, angular_size_cos) -> np.ndarray:
  """[cls, spec, img, direction(3), angular, disk, cos]."""
  def col(a):
    return np.asarray(a).astype(np.float32)[:, None]
  return np.concatenate([
      col(cls), col(emission_spec), col(emission_img),
      np.asarray(direction, np.float32),
      col(angular_size), col(equivalent_disk_size), col(angular_size_cos),
  ], axis=1)


class ProfileRows:
  def __init__(self, rows: torch.Tensor):
    self.cls = rows[:, 0].to(torch.int32)
    self.emission_spec = rows[:, 1].to(torch.int32)
    self.emission_img = rows[:, 2].to(torch.int32)
    self.direction = rows[:, 3:6]
    self.angular_size = rows[:, 6]
    self.equivalent_disk_size = rows[:, 7]
    self.angular_size_cos = rows[:, 8]
