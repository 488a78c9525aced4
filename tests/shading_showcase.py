"""The all-classes shading showcase, staged through either package's builder.

The spectral Cornell box (its conductor tall box kept; the ceiling light
emitting a 4000 K white LED, `spectral_data.led`) with nine icospheres,
one a shading feature, each with per-vertex normals and spherical uvs:

    plastic      Plastic under a checkered scattering image
    velvet       Velvet
    translucent  Translucent
    principled   Principled: metalness, roughness and normal-map images,
                 transmission 0.3
    mirror       Mirror
    diffuse_v1   Diffuse variation 1 (the Heitz rough-diffuse walk)
    diffuse_v2   Diffuse variation 2 (the vMF rough diffuse)
    void         Void
    alpha        Diffuse of opacity 0.7 whose scattering image has
                 cut-out holes in its alpha channel

At icosphere order 2 (320 triangles each) the whole showcase holds
36 + 9 x 320 = 2,916 triangles. `showcase` takes the package's modules as
arguments and uses numpy only, so the tests stage the JAX package's scene
and the port's from the same code, and `chip_smoke.py` stages the port's
without JAX. `spheres` picks a subset (the tests split the classes over
smaller scenes, each a JAX compile of its own); the textures are small
procedural images made here.
"""

from __future__ import annotations

import numpy as np

SPHERES = ("plastic", "velvet", "translucent", "principled", "mirror", "diffuse_v1",
           "diffuse_v2", "void", "alpha")
# a 3x3 grid in front of the boxes, clear of both and of the light
_X = (-0.55, 0.0, 0.55)
_Y = (1.65, 1.25, 0.85)
_Z = 0.75
_RADIUS = 0.17
_TEXTURE = 64
_LED_SCALE = 7.0  # the LED's luminance (0.71) to about the Cornell light's (5)


def icosphere(order: int):
  """(positions (V,3) on the unit sphere, indices (T,3)): an icosahedron
  subdivided `order` times, 20 x 4^order triangles."""
  t = (1.0 + 5.0 ** 0.5) / 2.0
  verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
           (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
  faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
           (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
           (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
  pos = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
  for _ in range(order):
    mid = {}

    def midpoint(a, b):
      key = (min(a, b), max(a, b))
      if key not in mid:
        m = pos[a] + pos[b]
        pos.append(m / np.linalg.norm(m))
        mid[key] = len(pos) - 1
      return mid[key]

    new = []
    for a, b, c in faces:
      ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
      new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
    faces = new
  return np.asarray(pos, np.float32), np.asarray(faces, np.int32)


def _sphere_uv(n: np.ndarray) -> np.ndarray:
  u = np.arctan2(n[:, 2], n[:, 0]) / (2.0 * np.pi) + 0.5
  v = np.arccos(np.clip(n[:, 1], -1.0, 1.0)) / np.pi
  return np.stack([u, v], axis=-1).astype(np.float32)


def _grid(n: int = _TEXTURE):
  c = (np.arange(n) + 0.5) / n
  return np.meshgrid(c, c)


def checker_image() -> np.ndarray:
  """An 8x8 checkerboard of two colours, alpha 1."""
  x, y = _grid()
  odd = ((np.floor(x * 8) + np.floor(y * 8)) % 2)[..., None]
  img = np.ones((_TEXTURE, _TEXTURE, 4), np.float32)
  img[..., :3] = odd * np.array([0.9, 0.85, 0.2]) + (1 - odd) * np.array([0.15, 0.3, 0.8])
  return img


def stripes_image(period: float, lo: float, hi: float) -> np.ndarray:
  """Grey stripes along u between lo and hi (a metalness or roughness map)."""
  x, _ = _grid()
  v = lo + (hi - lo) * (0.5 + 0.5 * np.sin(2.0 * np.pi * x * period))
  img = np.ones((_TEXTURE, _TEXTURE, 4), np.float32)
  img[..., :3] = v[..., None]
  return img


def bump_normal_image() -> np.ndarray:
  """A tangent-space normal map of a sine heightfield, encoded as
  (n + 1) / 2."""
  x, y = _grid()
  k = 6.0 * 2.0 * np.pi
  dx = 0.35 * np.cos(k * x) * np.sin(k * y)
  dy = 0.35 * np.sin(k * x) * np.cos(k * y)
  n = np.stack([-dx, -dy, np.ones_like(dx)], axis=-1)
  n /= np.linalg.norm(n, axis=-1, keepdims=True)
  img = np.ones((_TEXTURE, _TEXTURE, 4), np.float32)
  img[..., :3] = 0.5 * (n + 1.0)
  return img


def cutout_image() -> np.ndarray:
  """A light colour whose alpha is 0 inside a lattice of round holes."""
  x, y = _grid()
  fx, fy = x * 6 % 1.0 - 0.5, y * 6 % 1.0 - 0.5
  img = np.ones((_TEXTURE, _TEXTURE, 4), np.float32)
  img[..., :3] = (0.85, 0.8, 0.75)
  img[..., 3] = (fx * fx + fy * fy > 0.09).astype(np.float32)
  return img


def showcase(cornell, builder, types, spectrum, spectral_data, film_size=(512, 512),
             spheres=SPHERES, spectral=True, max_path_length=16, order=2,
             diffuse_only=False):
  """Stage the showcase in a package: cornell, builder, types, spectrum
  and spectral_data are that package's `scene.cornell`, `scene.builder`,
  `scene.types`, `core.spectrum` and `scene.spectral_data` modules.
  Returns the SceneBuilder (call .build())."""
  MC = types.MaterialClass
  SD = spectrum.SpectralDistribution
  b = cornell.build_cornell_box(film_size=film_size, spectral=spectral,
                                max_path_length=max_path_length, diffuse_only=diffuse_only)
  led = spectral_data.led(4000.0)
  b.spectra[b.materials[b.material_names["light"]].emission_spec] = SD(
      led.values * _LED_SCALE, SD.CLASS_ILLUMINANT)

  def rgb(v):
    return b.add_rgb_reflectance(np.asarray(v, np.float32))

  def material(**kw):
    return builder.MaterialDesc(**kw)

  make = {
      "plastic": lambda: material(
          name="plastic", cls=MC.Plastic, scattering_spec=rgb((0.8, 0.8, 0.8)),
          scattering_img=b.add_image(checker_image()), reflectance_spec=rgb((1.0, 1.0, 1.0)),
          roughness=(0.15, 0.15)),
      "velvet": lambda: material(
          name="velvet", cls=MC.Velvet, scattering_spec=rgb((0.55, 0.08, 0.12)),
          reflectance_spec=rgb((0.9, 0.6, 0.6)), roughness=(0.5, 0.5)),
      "translucent": lambda: material(
          name="translucent", cls=MC.Translucent, scattering_spec=rgb((0.2, 0.6, 0.3)),
          reflectance_spec=rgb((0.5, 0.5, 0.45))),
      "principled": lambda: material(
          name="principled", cls=MC.Principled, scattering_spec=rgb((0.7, 0.5, 0.3)),
          reflectance_spec=rgb((0.95, 0.8, 0.55)), roughness=(0.4, 0.4),
          roughness_img=b.add_image(stripes_image(3.0, 0.2, 1.0)), metalness=1.0,
          metalness_img=b.add_image(stripes_image(5.0, 0.0, 1.0)), transmission=0.3,
          normal_img=b.add_image(bump_normal_image()), normal_scale=1.0),
      "mirror": lambda: material(name="mirror", cls=MC.Mirror,
                                 scattering_spec=rgb((0.9, 0.9, 0.9))),
      "diffuse_v1": lambda: material(
          name="diffuse_v1", cls=MC.Diffuse, scattering_spec=rgb((0.3, 0.45, 0.8)),
          roughness=(0.6, 0.6), diffuse_variation=1),
      "diffuse_v2": lambda: material(
          name="diffuse_v2", cls=MC.Diffuse, scattering_spec=rgb((0.8, 0.55, 0.25)),
          roughness=(0.6, 0.6), diffuse_variation=2),
      "void": lambda: material(name="void", cls=MC.Void),
      "alpha": lambda: material(
          name="alpha", cls=MC.Diffuse, scattering_spec=rgb((1.0, 1.0, 1.0)),
          scattering_img=b.add_image(cutout_image()), opacity=0.7, two_sided=True),
  }
  pos, idx = icosphere(order)
  uv = _sphere_uv(pos)
  for slot, name in enumerate(SPHERES):
    if name not in spheres:
      continue
    m = b.add_material(make[name]())
    center = np.array([_X[slot % 3], _Y[slot // 3], _Z], np.float32)
    b.add_mesh(pos * _RADIUS + center, idx, m, normals=pos, uvs=uv)
  return b
