"""The volumetric scenes: bench config 4, the subsurface Cornell boxes and a
fog with a Boundary cube and a radiance clamp.

`volumetric` is the counterpart of `benchmarks/scenes.py:volumetric` (the
JAX package's bench config 4): the diffuse Cornell box filled with a
heterogeneous cloud, whose 24^3 density grid is written as a Mitsuba `.vol`
file into the per-user cache and loaded back through the density loader
(`scene/obj_loader.py`), RGB, maximum path length 10. It copies the JAX
scene as it is, including its subsurface step, which makes every material
whose name contains "box" random-walk SSS: the diffuse Cornell box names
its materials white, gray, red, green and light, so no material matches and
the scene renders no subsurface scattering (`has_subsurface` is False).

`subsurface_cornell` is the configuration of the JAX package's
`tests/test_media.py::test_sss_render`: the diffuse Cornell box with its
gray material (back wall and both boxes) made subsurface, random walk or
Christensen-Burley. `fog_boundary_cornell` fills the box with a homogeneous
fog and hangs in it a cube of Boundary material that holds a second,
absorbing homogeneous medium, with a radiance clamp on every sample.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.scene import types as st
from etx_tracer_tpu_torch.scene.builder import MaterialDesc, MediumDesc
from etx_tracer_tpu_torch.scene.cornell import _box, build_cornell_box
from etx_tracer_tpu_torch.scene.obj_loader import load_density_grid

CLOUD_SHAPE = (24, 24, 24)


def _expected_grid():
  rs = np.random.RandomState(7)
  g = rs.uniform(0.0, 1.0, CLOUD_SHAPE).astype(np.float32)
  # smooth spherical falloff: cloud-like
  z, y, x = np.mgrid[0:24, 0:24, 0:24].astype(np.float32) / 23.0 - 0.5
  g *= np.clip(1.0 - 2.2 * np.sqrt(x * x + y * y + z * z), 0.0, 1.0)
  return g


def _cloud_vol_path():
  """The bench cloud as a `.vol` file in the per-user cache
  ($XDG_CACHE_HOME, else ~/.cache, under etx_tracer_tpu/), written once
  and rewritten when the file there does not hold the expected grid."""
  cache_dir = os.path.join(
      os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")), "etx_tracer_tpu")
  os.makedirs(cache_dir, exist_ok=True)
  path = os.path.join(cache_dir, "etx_bench_cloud_v1.vol")
  if os.path.isfile(path):
    g = load_density_grid(path)
    if g is not None and g.shape == CLOUD_SHAPE \
        and np.allclose(np.asarray(g), _expected_grid(), atol=1e-6):
      return path
  g = _expected_grid()
  with open(path, "wb") as f:
    f.write(b"VOL")
    f.write(bytes([3]))                                  # version
    f.write(struct.pack("<iiiii", 1, 24, 24, 24, 1))     # float32, resolution, channels
    f.write(struct.pack("<6f", -0.5, -0.5, -0.5, 0.5, 0.5, 0.5))
    f.write(np.ascontiguousarray(g).tobytes())           # z, y, x order
  return path


def volumetric(size=(384, 384)):
  """Bench config 4: the heterogeneous cloud over the diffuse Cornell box,
  the grid loaded back from its `.vol` file. Returns a SceneBuilder."""
  g = load_density_grid(_cloud_vol_path())
  if g is None or g.shape != CLOUD_SHAPE:
    raise ValueError(f"the cloud grid did not load back as {CLOUD_SHAPE}")
  b = build_cornell_box(film_size=size, diffuse_only=True, max_path_length=10,
                        fog_grid=np.asarray(g, np.float32))
  d = b.add_spectrum(sp.SpectralDistribution.rgb_reflectance([0.6, 0.3, 0.1]))
  for name, idx in b.material_names.items():
    if "box" in name:
      b.materials[idx] = dataclasses.replace(
          b.materials[idx], subsurface_cls=st.SubsurfaceClass.RandomWalk, subsurface_spec=d)
  return b


def subsurface_cornell(size, cls=st.SubsurfaceClass.RandomWalk):
  """The diffuse Cornell box with its gray material subsurface (class `cls`,
  mean free paths rgb 0.3, 0.1, 0.05), maximum path length 6. Returns a
  SceneBuilder."""
  b = build_cornell_box(film_size=size, diffuse_only=True, max_path_length=6)
  gi = b.material_names["gray"]
  dist = b.add_spectrum(sp.SpectralDistribution.rgb_reflectance([0.3, 0.1, 0.05]))
  b.materials[gi] = dataclasses.replace(b.materials[gi], subsurface_cls=cls,
                                        subsurface_spec=dist)
  return b


# the fog, the cube's medium and the clamp of `fog_boundary_cornell`
FOG_SCATTERING = 0.3
FOG_G = 0.3
CUBE_SCATTERING = (0.9, 0.5, 0.2)
CUBE_ABSORPTION = (0.1, 0.2, 0.4)
CUBE_G = -0.2
RADIANCE_CLAMP = 1.0


def fog_boundary_cornell(size):
  """The diffuse Cornell box in a homogeneous fog, with a cube of Boundary
  material (a 0.5 cube above the short box, turned 25 degrees) whose
  interior holds a second homogeneous medium, and a radiance clamp;
  maximum path length 6. Returns a SceneBuilder."""
  b = build_cornell_box(film_size=size, diffuse_only=True, max_path_length=6,
                        fog_scattering=FOG_SCATTERING, fog_g=FOG_G)
  scat = b.add_spectrum(sp.SpectralDistribution.rgb_reflectance(CUBE_SCATTERING))
  absorb = b.add_spectrum(sp.SpectralDistribution.rgb_reflectance(CUBE_ABSORPTION))
  inside = b.add_medium(MediumDesc(name="cube", cls=1, scattering_spec=scat,
                                   absorption_spec=absorb, phase_g=CUBE_G))
  interface = b.add_material(MaterialDesc(name="interface", cls=st.MaterialClass.Boundary,
                                          int_medium=inside, ext_medium=b.camera_medium))
  _box(b, (0.3, 0.75, 0.3), (0.5, 0.5, 0.5), 25.0, interface)
  b.radiance_clamp = RADIANCE_CLAMP
  return b
