"""The large-geometry scene: twelve icospheres in the Cornell box.

Counterpart of `benchmarks/scenes.py:bigscene` (the JAX package's large-scene
bench workload), staged with the same numpy code and the same random draws
(`np.random.RandomState(5)`, in the same order) so that both packages freeze
identical tables: the diffuse Cornell box (36 triangles) and a 4 x 3 grid of
order-3 icospheres (1,280 triangles each) with Diffuse materials of six
colours, 15,396 triangles in all. RGB, maximum path length 8.

Above 4096 triangles the trace dispatch walks the scene's BVH, so this scene
runs the fat-node BVH kernels K5/K6 (`ops/bvh_trace.py`).
"""

from __future__ import annotations

import numpy as np

from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.scene import types as st
from etx_tracer_tpu_torch.scene.builder import MaterialDesc
from etx_tracer_tpu_torch.scene.cornell import build_cornell_box
from etx_tracer_tpu_torch.scene.materials import icosphere

NUM_TRIANGLES = 15396

_COLORS = [(0.8, 0.3, 0.2), (0.2, 0.7, 0.3), (0.3, 0.4, 0.8),
           (0.8, 0.7, 0.2), (0.7, 0.3, 0.7), (0.3, 0.7, 0.7)]


def build_bigscene(size=(512, 512)):
  """Stage the scene; returns a SceneBuilder (call .build(device))."""
  b = build_cornell_box(film_size=size, diffuse_only=True, max_path_length=8)
  rs = np.random.RandomState(5)
  for gx in range(4):
    for gy in range(3):
      cx = -0.65 + gx * 0.44
      cz = -0.5 + gy * 0.5
      r = 0.13 + 0.05 * rs.rand()
      m = b.add_material(MaterialDesc(
          name=f"s{gx}{gy}", cls=st.MaterialClass.Diffuse,
          scattering_spec=b.add_spectrum(sp.SpectralDistribution.rgb_reflectance(
              np.asarray(_COLORS[(gx * 3 + gy) % len(_COLORS)], np.float32)))))
      verts, faces, normals = icosphere((cx, r + 0.3 * rs.rand(), cz), r, order=3)
      b.add_mesh(verts, faces, m, normals=normals)
  return b
