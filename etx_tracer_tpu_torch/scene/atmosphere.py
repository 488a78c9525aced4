"""Atmosphere sun and sky precompute, and bench config 3's scene.

Counterpart of `etx_tracer_tpu/scene/atmosphere.py`: a sky environment map
and a sun-disk image, computed on the host in float64 numpy by fixed-step
marching over (pixels x steps x wavelengths), and added to a scene as an
ordinary Environment emitter and Directional emitter. The code is the JAX
package's, operation for operation, reading the port's own spectrum tables
(`core/spectrum.py`), so both packages freeze the same images bit for bit.
`atmosphere_scene` is the JAX bench's config 3 (`benchmarks/scenes.py:
atmosphere_scene`): a ground quad and an open unit box (12 Diffuse
triangles) under the sun and the sky, seen through a thin lens, spectral,
maximum path length 8. `env_floor_scene` is the JAX package's small
environment-map test scene.
"""

from __future__ import annotations

import numpy as np

from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.scene import types as st
from etx_tracer_tpu_torch.scene.builder import EmitterProfileDesc, MaterialDesc, SceneBuilder

kPlanetRadius = 6371e3
kAtmosphereRadius = 120e3
kOuterSphereSize = kPlanetRadius + kAtmosphereRadius
kRayleighDensityScale = 7994.0
kMieDensityScale = 1200.0

_N_STEPS = 128
_LUT_SIZE = 256


def rayleigh_spectrum(wl):
  l = wl / 100.0
  return 1.169939 / (l ** 4 * 100.0)


def mie_spectrum(wl):
  return 0.3954608 * np.pi ** 3 / (wl * wl)


def ozone_absorption(wl):
  na = 6.022140857
  concentration = 41.58e-6
  x = wl
  base = (-1.109902e-15 * x ** 6 + 3.950001e-12 * x ** 5 - 5.784719e-09 * x ** 4
          + 4.460262e-06 * x ** 3 - 1.909367e-03 * x ** 2 + 4.303677e-01 * x
          - 3.992226e+01)
  return np.where(base > 0.0, base * na * concentration, 0.0)


def density(h):
  """(rayleigh, mie, ozone) density profile at height h [m]."""
  h = np.maximum(h, 0.0)
  x = h / 1000.0
  f = (3.759384e-08 * x ** 6 - 1.067250e-05 * x ** 5 + 1.080311e-03 * x ** 4
       - 4.851181e-02 * x ** 3 + 9.185432e-01 * x ** 2 - 4.886021e+00 * x
       + 7.900478e+00)
  ozone = np.maximum(0.0, f / 30.8491249)
  return np.stack([np.exp(-h / kRayleighDensityScale),
                   np.exp(-h / kMieDensityScale),
                   ozone], axis=-1)


def _distance_to_sphere(o, d, radius):
  b = np.sum(d * o, axis=-1)
  disc = b * b - np.sum(o * o, axis=-1) + radius * radius
  s = np.sqrt(np.maximum(disc, 0.0))
  a0 = -b - s
  a1 = -b + s
  t = np.where(a0 < 0.0, np.where(a1 < 0.0, 0.0, a1), a0)
  return np.where(disc < 0.0, 0.0, t)


def _march_optical_length(origin, direction, total):
  """Integrate density along rays (origin (N,3), direction (N,3), total (N,))
  with sqrt-spaced fixed steps (denser near the origin)."""
  n = origin.shape[0]
  u = (np.arange(_N_STEPS) + 0.5) / _N_STEPS
  frac = u ** 1.5  # denser sampling at low altitude
  edges = np.concatenate([[0.0], (np.arange(_N_STEPS) + 1.0) / _N_STEPS]) ** 1.5
  dt = (edges[1:] - edges[:-1])[None, :] * total[:, None]
  t_mid = frac[None, :] * total[:, None]
  p = origin[:, None, :] + direction[:, None, :] * t_mid[..., None]
  h = np.linalg.norm(p, axis=-1) - kPlanetRadius
  d = density(h)  # (N, S, 3)
  return np.sum(d * dt[..., None], axis=1)


def build_optical_length_lut(size: int = _LUT_SIZE):
  """Precomputed optical-length LUT over (n_dot_l, height)."""
  xs, ys = np.meshgrid((np.arange(size) + 0.5) / size,
                       (np.arange(size) + 0.5) / size)
  h = ys.reshape(-1) ** 2 * kAtmosphereRadius
  n_dot_l = np.sqrt(xs.reshape(-1)) * 2.0 - 1.0
  direction = np.stack([np.sqrt(np.maximum(1.0 - n_dot_l ** 2, 0.0)), n_dot_l,
                        np.zeros_like(n_dot_l)], axis=-1)
  origin = np.stack([np.zeros_like(h), kPlanetRadius + h, np.zeros_like(h)], axis=-1)
  total = _distance_to_sphere(origin, direction, kOuterSphereSize)
  ol = _march_optical_length(origin, direction, total)
  return ol.reshape(size, size, 3).astype(np.float32)


def _sample_lut(lut, pos, light_dir):
  """The optical length toward the light: LUT lookup by (n_dot_l, height)."""
  size = lut.shape[0]
  height = np.linalg.norm(pos, axis=-1)
  n_dot_l = np.sum(pos / height[..., None] * light_dir, axis=-1)
  u = (n_dot_l * 0.5 + 0.5) ** 2
  v = np.sqrt(np.clip((height - kPlanetRadius) / kAtmosphereRadius, 0.0, 1.0))
  xi = np.clip((u * size).astype(np.int32), 0, size - 1)
  yi = np.clip((v * size).astype(np.int32), 0, size - 1)
  return lut[yi, xi]


class Parameters:
  def __init__(self, altitude=50.0, anisotropy=0.75, rayleigh_scale=1.0,
               mie_scale=1.0, ozone_scale=1.0):
    self.altitude = altitude
    self.anisotropy = anisotropy
    self.rayleigh_scale = rayleigh_scale
    self.mie_scale = mie_scale
    self.ozone_scale = ozone_scale


def _wavelength_tables(step=5):
  wl = sp.GRID[::step]
  r = rayleigh_spectrum(wl)
  m = mie_spectrum(wl)
  o = ozone_absorption(wl)
  xyz = sp._xyz_bar_np(wl)
  return wl, r, m, o, xyz


def generate_sky_image(params: Parameters, dimensions=(256, 128),
                       light_direction=(0.0, 0.866, 0.5), lut=None):
  """Equirectangular sky radiance image.

  Returns (H, W, 4) float32 RGB (+poor-man multiple-scattering boost).
  """
  w, h = dimensions
  lut = lut if lut is not None else build_optical_length_lut()
  light = np.asarray(light_direction, np.float64)
  light /= np.linalg.norm(light)

  wl, r_s, m_s, o_s, xyz = _wavelength_tables()
  n_wl = len(wl)
  scale = np.array([params.rayleigh_scale, params.mie_scale, params.ozone_scale])

  xs, ys = np.meshgrid(np.arange(w), np.arange(h))
  u = (xs.reshape(-1) + 0.5) / w * 2.0 - 1.0
  v = (ys.reshape(-1) + 0.5) / h * 2.0 - 1.0
  phi = u * np.pi
  theta = v * (np.pi / 2.0)
  view = np.stack([np.cos(phi) * np.cos(theta), np.sin(theta),
                   np.sin(phi) * np.cos(theta)], axis=-1)
  n = view.shape[0]

  origin = np.array([0.0, kPlanetRadius + params.altitude, 0.0])[None, :]
  to_space = _distance_to_sphere(np.broadcast_to(origin, (n, 3)), view, kOuterSphereSize)
  to_planet = _distance_to_sphere(np.broadcast_to(origin, (n, 3)), view, kPlanetRadius)
  total = np.where(to_planet > 0.0, to_planet, to_space)

  l_dot_v = view @ light
  phase_r = (3.0 / 4.0) * (1.0 + l_dot_v ** 2) / (2.0 * np.pi)
  g = params.anisotropy
  phase_m = ((3.0 / 2.0) * ((1.0 - g * g) * (1.0 + l_dot_v ** 2))
             / ((2.0 + g * g) * (1.0 + g * g - 2.0 * g * l_dot_v) ** 1.5)
             / (2.0 * np.pi))

  # fixed-step march accumulating per-wavelength radiance
  uu = (np.arange(_N_STEPS) + 0.5) / _N_STEPS
  frac = uu ** 1.5
  edges = np.concatenate([[0.0], (np.arange(_N_STEPS) + 1.0) / _N_STEPS]) ** 1.5
  radiance = np.zeros((n, n_wl))
  view_path = np.zeros((n, 3))
  for s in range(_N_STEPS):
    dt = (edges[s + 1] - edges[s]) * total
    t_mid = frac[s] * total
    p = origin + view * t_mid[:, None]
    hgt = np.linalg.norm(p, axis=-1) - kPlanetRadius
    dens = density(hgt) * scale[None, :]
    view_path += dt[:, None] * dens
    light_path = _sample_lut(lut, p, light) * scale[None, :]
    tot = view_path + light_path  # (N,3)
    tr = np.exp(-(np.outer(tot[:, 0], r_s) + np.outer(tot[:, 1], m_s)
                  + np.outer(tot[:, 2], o_s)))
    src = (phase_r * dens[:, 0])[:, None] * r_s[None, :] \
        + (phase_m * dens[:, 1])[:, None] * m_s[None, :]
    radiance += tr * src * dt[:, None]

  xyz_img = radiance @ xyz / sp.Y_INTEGRAL * (sp.GRID.shape[0] / n_wl)
  rgb = np.maximum(xyz_img @ sp.XYZ_TO_RGB.T, 0.0)

  # poor-man multiple scattering
  upper = v > 0.0
  weight = np.where(upper, np.sin(np.maximum(v, 0.0) * np.pi / 2.0), 0.0)
  avg = (rgb * weight[:, None]).sum(0) / max(weight.sum(), 1e-9)
  rgb = rgb + 2.0 * np.pi * avg[None, :] * rgb + avg[None, :]

  img = np.zeros((h, w, 4), np.float32)
  img[..., :3] = rgb.reshape(h, w, 3)
  # rows written bottom-up
  img[..., :3] = img[::-1, :, :3]
  img[..., 3] = 1.0
  return img


def generate_sun_image(params: Parameters, dimensions=(64, 64),
                       light_direction=(0.0, 0.866, 0.5),
                       angular_size=np.deg2rad(0.5)):
  """Sun disk image with atmosphere extinction + limb darkening."""
  w, h = dimensions
  light = np.asarray(light_direction, np.float64)
  light /= np.linalg.norm(light)

  # orthonormal basis
  a = np.array([light[2] - light[1], light[0] - light[2], light[1] - light[0]])
  if np.linalg.norm(a) < 1e-8:
    a = np.array([1.0, 0.0, 0.0])
  a /= np.linalg.norm(a)
  b = np.cross(light, a)

  wl, r_s, m_s, o_s, xyz = _wavelength_tables()
  tan_half = np.tan(0.5 * angular_size)

  xs, ys = np.meshgrid(np.arange(w), np.arange(h))
  u = (xs.reshape(-1) + 0.5) / w * 2.0 - 1.0
  v = (ys.reshape(-1) + 0.5) / h * 2.0 - 1.0
  d = tan_half * (u[:, None] * a[None, :] + v[:, None] * b[None, :]) + light[None, :]
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  n = d.shape[0]

  origin = np.array([0.0, kPlanetRadius + params.altitude, 0.0])[None, :]
  hits_planet = _distance_to_sphere(np.broadcast_to(origin, (n, 3)), d, kPlanetRadius) > 0.0
  total = _distance_to_sphere(np.broadcast_to(origin, (n, 3)), d, kOuterSphereSize)
  path = _march_optical_length(np.broadcast_to(origin, (n, 3)), d, total)
  scale = np.array([params.rayleigh_scale, params.mie_scale, params.ozone_scale])
  path = path * scale[None, :]
  tr = np.exp(-(np.outer(path[:, 0], r_s) + np.outer(path[:, 1], m_s)
                + np.outer(path[:, 2], o_s)))
  tr[hits_planet] = 0.0

  darkening = 1.0 - 0.6 * (1.0 - np.maximum(0.0, 1.0 - (u ** 2 + v ** 2)))
  xyz_img = (tr @ xyz / sp.Y_INTEGRAL * (sp.GRID.shape[0] / len(wl))) * darkening[:, None]
  rgb = np.maximum(xyz_img @ sp.XYZ_TO_RGB.T, 0.0)
  img = np.zeros((h, w, 4), np.float32)
  img[..., :3] = rgb.reshape(h, w, 3)
  img[..., 3] = 1.0
  return img


def add_atmosphere(builder, direction=(0.0, 0.866, 0.5), params: Parameters | None = None,
                   sun_scale: float = 1.0, sky_scale: float = 1.0,
                   sky_size=(256, 128), sun_size=(64, 64),
                   angular_size=np.deg2rad(0.53)):
  """Add the sun and the sky to a SceneBuilder: the sky image (with a
  sampling distribution) as an Environment emitter, the sun image as a
  Directional emitter of `angular_size` about `direction`, both of a white
  luminance spectrum."""
  params = params or Parameters()
  lut = build_optical_length_lut()
  sky = generate_sky_image(params, sky_size, direction, lut) * sky_scale
  sky[..., 3] = 1.0
  sun = generate_sun_image(params, sun_size, direction, angular_size) * sun_scale
  sun[..., 3] = 1.0

  sky_img = builder.add_image(sky, build_cdf=True)
  sun_img = builder.add_image(sun, build_cdf=False)
  white = builder.add_spectrum(sp.SpectralDistribution.rgb_luminance([1.0, 1.0, 1.0]))
  builder.add_distant_emitter(EmitterProfileDesc(
      cls=st.EmitterClass.Environment, emission_spec=white, emission_img=sky_img))
  builder.add_distant_emitter(EmitterProfileDesc(
      cls=st.EmitterClass.Directional, emission_spec=white, emission_img=sun_img,
      direction=tuple(direction), angular_size=float(angular_size)))
  return builder


NUM_TRIANGLES = 12


def atmosphere_scene(size=(512, 512), sky_size=(256, 128)):
  """Bench config 3: the sun and the sky over a 100x100 ground quad and an
  open unit box, a thin lens (radius 0.02, focal distance 5.5), spectral,
  maximum path length 8. `sky_size` other than the bench's (256, 128) is
  for tests on the CPU, where the full sky takes seconds to march."""
  b = SceneBuilder()
  b.spectral = True
  ground = b.add_material(MaterialDesc(name="ground", cls=st.MaterialClass.Diffuse,
                                       scattering_spec=1))
  b.add_mesh(np.array([[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]], np.float32),
             np.array([[0, 1, 2], [0, 2, 3]], np.int32), ground)
  box = b.add_material(MaterialDesc(name="box", cls=st.MaterialClass.Diffuse,
                                    scattering_spec=1))
  bv = np.array([[-.5, 0, -.5], [.5, 0, -.5], [.5, 1, -.5], [-.5, 1, -.5],
                 [-.5, 0, .5], [.5, 0, .5], [.5, 1, .5], [-.5, 1, .5]], np.float32)
  bf = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 3, 7], [0, 7, 4],
                 [1, 5, 6], [1, 6, 2], [3, 2, 6], [3, 6, 7]], np.int32)
  b.add_mesh(bv, bf, box)
  add_atmosphere(b, direction=(0.3, 0.6, 0.5), sky_size=sky_size)
  b.set_camera((4.0, 1.2, 4.0), (0.0, 0.5, 0.0), (0, 1, 0), 45.0, size,
               lens_radius=0.02, focal_distance=5.5)
  b.max_path_length = 8
  return b


def env_floor_scene(size=(16, 16), max_path_length: int = 3, spectral: bool = False):
  """A 2x2 Diffuse floor (0.8, two-sided) under an 8x16 environment map
  whose upper half is (2, 1, 0.5) and lower half black, times the white
  spectrum: the JAX package's image test scene
  (`tests/test_images.py::test_env_render_with_image`)."""
  b = SceneBuilder()
  b.film_size = tuple(size)
  b.max_path_length = max_path_length
  b.spectral = spectral
  white = b.add_rgb_reflectance([0.8, 0.8, 0.8])
  m = b.add_material(MaterialDesc(cls=st.MaterialClass.Diffuse, scattering_spec=white,
                                  two_sided=True))
  b.add_mesh(np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32),
             np.array([[0, 1, 2], [0, 2, 3]], np.int32), m)
  env = np.zeros((8, 16, 4), np.float32)
  env[:4] = [2.0, 1.0, 0.5, 1.0]
  img = b.add_image(env, build_cdf=True)
  b.add_distant_emitter(EmitterProfileDesc(cls=st.EmitterClass.Environment, emission_spec=1,
                                           emission_img=img))
  b.set_camera(origin=(0, 1.0, 3), target=(0, 0.5, 0), up=(0, 1, 0), fov=60, film_size=size)
  return b
