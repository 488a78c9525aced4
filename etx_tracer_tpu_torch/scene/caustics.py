"""The caustics scene: a glass torus over the floor of the Cornell box.

Counterpart of `benchmarks/scenes.py:caustics` (the JAX package's bench
config 5), staged with the same numpy code so that both packages freeze
identical tables: the Cornell box with its smooth conductor tall box
(36 triangles), plus a torus of major radius 0.45 and minor radius 0.12,
32 x 16 segments (1,024 triangles, with per-vertex normals), a smooth
Dielectric of constant IOR 1.52; 1,060 triangles in all. Spectral by
default, maximum path length 16.

Both packages render it with VCM (bench config 5); their
micro-benchmarks (`benchmarks/micro.py trace_brute`) trace it.
"""

from __future__ import annotations

import numpy as np

from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.scene import types as st
from etx_tracer_tpu_torch.scene.builder import MaterialDesc
from etx_tracer_tpu_torch.scene.cornell import build_cornell_box

NUM_TRIANGLES = 1060


def torus(major=0.45, minor=0.12, nu=32, nv=16):
  """The bench torus, lying on the floor: (positions (V,3) float32, faces
  (F,3) int32, unit normals (V,3) float32)."""
  us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
  vs = np.linspace(0, 2 * np.pi, nv, endpoint=False)
  verts = []
  nrms = []
  for u in us:
    cu, su = np.cos(u), np.sin(u)
    for v in vs:
      cv, sv = np.cos(v), np.sin(v)
      verts.append(((major + minor * cv) * cu, minor * sv + minor + 0.01,
                    (major + minor * cv) * su))
      nrms.append((cv * cu, sv, cv * su))
  faces = []
  for i in range(nu):
    for j in range(nv):
      a = i * nv + j
      b = i * nv + (j + 1) % nv
      c = ((i + 1) % nu) * nv + (j + 1) % nv
      d = ((i + 1) % nu) * nv + j
      faces += [[a, b, c], [a, c, d]]
  return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
          np.asarray(nrms, np.float32))


def build_caustics_scene(size=(512, 512), spectral=True):
  """Stage the caustics scene; returns a SceneBuilder (call .build(device))."""
  b = build_cornell_box(film_size=size, max_path_length=16)
  b.spectral = spectral
  glass_e = b.add_spectrum(sp.SpectralDistribution.constant(
      1.52, sp.SpectralDistribution.CLASS_DIELECTRIC))
  m_glass = b.add_material(MaterialDesc(
      name="ring", cls=st.MaterialClass.Dielectric,
      reflectance_spec=1, scattering_spec=1, int_ior_eta=glass_e))
  verts, faces, normals = torus()
  b.add_mesh(verts, faces, m_glass, normals=normals)
  return b
