"""The materials showcase: a gold, a glass and a thin-film sphere in the
Cornell box.

Counterpart of `benchmarks/scenes.py:materials` (the JAX package's bench
config 2), staged with the same numpy code so that both packages freeze
identical tables: the Cornell box with its smooth conductor tall box, plus
three order-2 icospheres of 320 triangles each, 996 triangles in all:

- gold: a rough conductor (alpha 0.05) with the Lorentz-Drude n/k of gold;
- glass: a smooth dielectric of constant eta 1.5;
- bubble: a thin film of eta 1.35 and 300-600 nm thickness.

Spectral by default, maximum path length 16, area emitters only (the
ceiling light).
"""

from __future__ import annotations

import numpy as np

from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.scene import ior as ior_mod
from etx_tracer_tpu_torch.scene import types as st
from etx_tracer_tpu_torch.scene.builder import MaterialDesc
from etx_tracer_tpu_torch.scene.cornell import build_cornell_box


def icosphere(center, radius, order=2):
  """Unit icosahedron subdivided `order` times onto the sphere, scaled and
  moved: (positions (V,3) float32, faces (F,3) int32, unit normals (V,3))."""
  t = (1.0 + np.sqrt(5.0)) / 2.0
  v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
  v /= np.linalg.norm(v, axis=1, keepdims=True)
  f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
               np.int32)
  for _ in range(order):
    nv = list(v)
    cache = {}
    nf = []

    def mid(a, b):
      key = (min(a, b), max(a, b))
      if key not in cache:
        m = v[a] + v[b]
        cache[key] = len(nv)
        nv.append(m / np.linalg.norm(m))
      return cache[key]

    for a, b, c in f:
      ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
      nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    v = np.asarray(nv)
    f = np.asarray(nf, np.int32)
  verts = v * radius + np.asarray(center)
  return verts.astype(np.float32), f, v.astype(np.float32)


def build_materials_scene(size=(512, 512), spectral=True):
  """Stage the materials showcase; returns a SceneBuilder (call .build(device))."""
  b = build_cornell_box(film_size=size, max_path_length=16)
  b.spectral = spectral
  db = ior_mod.IORDatabase()

  au = db.find("Au") or db.find("au")
  if au is not None:
    _, eta, k = au
    e = b.add_spectrum(eta)
    kk = b.add_spectrum(k) if k is not None else -1
  else:
    e = b.add_spectrum(sp.SpectralDistribution.constant(
        0.2, sp.SpectralDistribution.CLASS_CONDUCTOR))
    kk = b.add_spectrum(sp.SpectralDistribution.constant(
        3.0, sp.SpectralDistribution.CLASS_CONDUCTOR))
  m_gold = b.add_material(MaterialDesc(
      name="gold", cls=st.MaterialClass.Conductor,
      reflectance_spec=1, roughness=(0.05, 0.05),
      int_ior_eta=e, int_ior_k=kk,
      int_ior_cls=sp.SpectralDistribution.CLASS_CONDUCTOR))

  glass_e = b.add_spectrum(sp.SpectralDistribution.constant(
      1.5, sp.SpectralDistribution.CLASS_DIELECTRIC))
  m_glass = b.add_material(MaterialDesc(
      name="glass", cls=st.MaterialClass.Dielectric,
      reflectance_spec=1, scattering_spec=1, int_ior_eta=glass_e))

  tf_eta = b.add_spectrum(sp.SpectralDistribution.constant(
      1.35, sp.SpectralDistribution.CLASS_DIELECTRIC))
  m_tf = b.add_material(MaterialDesc(
      name="bubble", cls=st.MaterialClass.Thinfilm,
      reflectance_spec=1, scattering_spec=1,
      thinfilm_eta=tf_eta, thinfilm_min=300.0, thinfilm_max=600.0))

  for center, radius, m in [((-0.55, 0.35, 0.2), 0.35, m_gold),
                            ((0.0, 0.35, -0.3), 0.35, m_glass),
                            ((0.55, 0.35, 0.2), 0.35, m_tf)]:
    verts, faces, normals = icosphere(center, radius)
    b.add_mesh(verts, faces, m, normals=normals)
  return b
