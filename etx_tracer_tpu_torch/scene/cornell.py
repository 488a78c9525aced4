"""Procedural Cornell box test scene.

Counterpart of `etx_tracer_tpu/scene/cornell.py`: the same canonical
geometry (room x in [-1,1], y in [0,2], z in [-1,1], open towards the camera
at +z; two boxes; a ceiling light), camera and materials, staged with the
same numpy code so both packages freeze identical tables: 36 triangles and
two emitter triangles (none without the light), in RGB or spectral mode,
with a diffuse or (the default, as in the JAX package) a smooth conductor
tall box, in vacuum or filled with a homogeneous or heterogeneous fog.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.scene import types as st
from etx_tracer_tpu_torch.scene.builder import MaterialDesc, MediumDesc, SceneBuilder


def _quad(builder, p0, p1, p2, p3, material):
  """Add a quad (two triangles), counter-clockwise winding."""
  pos = np.asarray([p0, p1, p2, p3], np.float32)
  idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
  builder.add_mesh(pos, idx, material)


def _box(builder, center, size, rotation_y_deg, material):
  cx, cy, cz = center
  sx, sy, sz = size
  a = np.deg2rad(rotation_y_deg)
  c, s = np.cos(a), np.sin(a)

  def rot(p):
    x, y, z = p
    return (cx + c * x + s * z, cy + y, cz - s * x + c * z)

  hx, hz = sx / 2, sz / 2
  c000 = rot((-hx, 0, -hz)); c100 = rot((hx, 0, -hz))
  c110 = rot((hx, sy, -hz)); c010 = rot((-hx, sy, -hz))
  c001 = rot((-hx, 0, hz)); c101 = rot((hx, 0, hz))
  c111 = rot((hx, sy, hz)); c011 = rot((-hx, sy, hz))
  _quad(builder, c001, c101, c111, c011, material)  # front (+z)
  _quad(builder, c100, c000, c010, c110, material)  # back (-z)
  _quad(builder, c000, c001, c011, c010, material)  # left (-x)
  _quad(builder, c101, c100, c110, c111, material)  # right (+x)
  _quad(builder, c011, c111, c110, c010, material)  # top (+y)
  _quad(builder, c000, c100, c101, c001, material)  # bottom (-y)


def build_cornell_box(film_size=(640, 640), samples=32, spectral=False,
                      diffuse_only=False, max_path_length=1023, with_light=True,
                      fog_scattering=0.0, fog_g=0.0, fog_grid=None, specular_boxes=False):
  """Stage the Cornell box; returns a SceneBuilder (call .build(device)).

  fog_scattering > 0 fills the room with a homogeneous medium of that
  scattering (phase asymmetry fog_g) that the camera sits in; fog_grid, a
  (gz, gy, gx) density grid, makes it heterogeneous over the room's box
  instead (scattering 0.5 unless fog_scattering is set). Every material's
  exterior medium is then the fog. specular_boxes makes the tall box a
  smooth dielectric (eta 1.52) and the short box a mirror, both floating
  0.05 above the floor (their bottoms would otherwise be coplanar with it,
  a tie that intersectors break apart). Without its light
  (`with_light=False`) the box has no emitter of its own: add a distant one
  before building, or it freezes a single emitter of weight 0.
  """
  b = SceneBuilder()
  b.samples = samples
  b.spectral = spectral
  b.max_path_length = max_path_length
  b.rr_start = 6

  fog = fog_scattering > 0.0 or fog_grid is not None
  if fog:
    scat = b.add_spectrum(sp.SpectralDistribution.rgb_reflectance(
        np.full(3, fog_scattering if fog_scattering > 0.0 else 0.5, np.float32)))
    b.camera_medium = b.add_medium(MediumDesc(
        name="fog", cls=1 if fog_grid is None else 2,
        scattering_spec=scat, phase_g=fog_g, grid=fog_grid,
        bounds_min=(-1.0, 0.0, -1.0), bounds_max=(1.0, 2.0, 1.0)))

  # Kd values go through sRGB->linear like the reference MTL loader
  def lin(v):
    return np.where(np.asarray(v) <= 0.04045, np.asarray(v) / 12.92,
                    ((np.asarray(v) + 0.055) / 1.055) ** 2.4)

  white = b.add_rgb_reflectance(lin([1.0, 1.0, 1.0]))
  gray = b.add_rgb_reflectance(lin([0.906, 0.906, 0.906]))
  red = b.add_rgb_reflectance(lin([1.0, 0.0, 0.0]))
  green = b.add_rgb_reflectance(lin([0.0, 1.0, 0.0]))
  black = 0

  m_white = b.add_material(MaterialDesc(name="white", cls=st.MaterialClass.Diffuse,
                                        scattering_spec=white, two_sided=True))
  m_gray = b.add_material(MaterialDesc(name="gray", cls=st.MaterialClass.Diffuse,
                                       scattering_spec=gray, two_sided=True))
  m_red = b.add_material(MaterialDesc(name="red", cls=st.MaterialClass.Diffuse,
                                      scattering_spec=red, two_sided=True))
  m_green = b.add_material(MaterialDesc(name="green", cls=st.MaterialClass.Diffuse,
                                        scattering_spec=green, two_sided=True))
  m_short = m_gray
  if specular_boxes:
    glass_eta = b.add_spectrum(sp.SpectralDistribution.constant(
        1.52, sp.SpectralDistribution.CLASS_DIELECTRIC))
    m_tall = b.add_material(MaterialDesc(
        name="glassBox", cls=st.MaterialClass.Dielectric,
        reflectance_spec=white, scattering_spec=white, int_ior_eta=glass_eta,
        int_ior_cls=sp.SpectralDistribution.CLASS_DIELECTRIC, roughness=(0.0, 0.0)))
    m_short = b.add_material(MaterialDesc(
        name="mirrorBox", cls=st.MaterialClass.Mirror, scattering_spec=white, two_sided=True))
  elif diffuse_only:
    m_tall = m_gray
  else:
    # conductor tall box: silver-like constant complex IOR
    eta = b.add_spectrum(sp.SpectralDistribution.constant(
        0.15, sp.SpectralDistribution.CLASS_CONDUCTOR))
    k = b.add_spectrum(sp.SpectralDistribution.constant(
        3.8, sp.SpectralDistribution.CLASS_CONDUCTOR))
    m_tall = b.add_material(MaterialDesc(
        name="tallBox", cls=st.MaterialClass.Conductor,
        reflectance_spec=white, int_ior_eta=eta, int_ior_k=k,
        int_ior_cls=sp.SpectralDistribution.CLASS_CONDUCTOR,
        roughness=(0.0, 0.0), two_sided=True))

  # light: blackbody 2700K scaled 5.0, black diffuse base
  emission = b.add_spectrum(sp.SpectralDistribution.from_normalized_black_body(2700.0, 5.0))
  m_light = b.add_material(MaterialDesc(name="light", cls=st.MaterialClass.Diffuse,
                                        scattering_spec=black,
                                        emission_spec=emission if with_light else -1,
                                        two_sided=True))

  if fog:
    # everything sits inside the fog
    for i, m in enumerate(b.materials):
      b.materials[i] = dataclasses.replace(m, ext_medium=b.camera_medium)

  _quad(b, (-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1), m_white)      # floor (n=+y)
  _quad(b, (-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1), m_white)      # ceiling (n=-y)
  _quad(b, (-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1), m_gray)     # back wall (n=+z)
  _quad(b, (-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1), m_red)      # left wall (n=+x)
  _quad(b, (1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1), m_green)        # right wall (n=-x)

  dy = 0.05 if specular_boxes else 0.0
  _box(b, (0.33, dy, 0.37), (0.6, 0.6, 0.6), -17.0, m_short)    # short box
  _box(b, (-0.33, dy, -0.29), (0.6, 1.2, 0.6), 17.0, m_tall)    # tall box

  # ceiling light: small quad just below the ceiling, facing down (n=-y)
  h = 2.0 - 1e-3
  _quad(b, (-0.235, h, -0.19), (0.235, h, -0.19), (0.235, h, 0.16), (-0.235, h, 0.16), m_light)

  b.set_camera(origin=(0.0, 1.0, 3.82), target=(0.0, 1.0, -6.18),
               up=(0.0, 1.0, 0.0), fov=39.597755335771296,
               film_size=film_size, clip_near=0.1, clip_far=100.0)
  return b


def aperture_image(n: int = 16, blades: int = 6) -> np.ndarray:
  """An (n, n, 4) mask of a regular polygon with `blades` corners (1 inside,
  0 outside, alpha 1): a lens aperture's shape."""
  c = (np.arange(n) + 0.5) / n * 2.0 - 1.0
  x, y = np.meshgrid(c, c)
  ang = np.arctan2(y, x)
  sector = 2.0 * np.pi / blades
  edge = np.cos(sector / 2.0) / np.cos(np.mod(ang, sector) - sector / 2.0)
  inside = np.hypot(x, y) <= 0.95 * edge
  img = np.zeros((n, n, 4), np.float32)
  img[..., :3] = inside[..., None]
  img[..., 3] = 1.0
  return img


def build_dof_cornell_box(film_size=(640, 640), lens_radius=0.1, focal_distance=3.2,
                          aperture_blades=6, **kwargs):
  """The Cornell box through a thin lens (focused on the short box) whose
  aperture is a polygon image of the bank, sampled by its distribution."""
  b = build_cornell_box(film_size=film_size, **kwargs)
  b.lens_radius = float(lens_radius)
  b.focal_distance = float(focal_distance)
  b.camera_lens_image = b.add_image(aperture_image(blades=aperture_blades), build_cdf=True)
  return b
