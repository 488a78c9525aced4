"""Device scene tables and the static render configuration.

Counterpart of `etx_tracer_tpu/scene/types.py`, cut to what the port's
path tracer and VCM family read: NamedTuples
of torch tensors that all lie on one device, and a frozen `SceneConfig`. Field names and layouts
are the JAX package's, so a test can compare the two scenes field by field,
but for the BVH, which holds the port's kernel tables.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from etx_tracer_tpu_torch.render import images as images_mod
from etx_tracer_tpu_torch.scene import packed


class MaterialClass:
  """Material class ids (the JAX package's order)."""
  Diffuse = 0
  Translucent = 1
  Plastic = 2
  Conductor = 3
  Dielectric = 4
  Thinfilm = 5
  Mirror = 6
  Boundary = 7
  Velvet = 8
  Principled = 9
  Void = 10
  Count = 11


class EmitterClass:
  Area = 0
  Environment = 1
  Directional = 2
  Undefined = 3


class SubsurfaceClass:
  Disabled = 0
  RandomWalk = 1
  ChristensenBurley = 2


class Camera(NamedTuple):
  """Camera; scalars are 0-d tensors. A lens (depth of field) is on where
  `lens_radius` and `focal_distance` are both above kEpsilon; `lens_image`
  shapes its aperture by an image of the bank. `view_proj`, `area` and the
  lens serve light-to-camera connections (`render/camera.sample_film`)."""
  position: torch.Tensor      # (3,)
  direction: torch.Tensor     # (3,)
  side: torch.Tensor          # (3,)
  up: torch.Tensor            # (3,)
  view_proj: torch.Tensor     # (4,4) row-major: clip = view_proj @ [p, 1]
  tan_half_fov: torch.Tensor  # ()
  aspect: torch.Tensor        # ()
  area: torch.Tensor          # () image plane area at unit distance
  lens_radius: torch.Tensor   # ()
  focal_distance: torch.Tensor  # ()
  clip_near: torch.Tensor     # ()
  clip_far: torch.Tensor      # ()
  medium_index: torch.Tensor  # () int32 medium the camera sits in, -1: vacuum
  lens_image: torch.Tensor    # () int32 aperture-shape image, -1: a round lens


class Emitters(NamedTuple):
  """The power CDF over emitter instances (their records are em_table rows)
  and the distant (environment and directional) instances that a missed
  ray reads."""
  pdf: torch.Tensor            # (E,) float32 discrete selection pdf
  cdf: torch.Tensor            # (E,) float32 inclusive cdf
  total_weight: torch.Tensor   # () float32
  env_indices: torch.Tensor    # (64,) int32 distant instances of weight > 0, -1 padded
  env_count: torch.Tensor      # () int32


class ImageBank(NamedTuple):
  """Every image of the scene in one padded bank, with what sampling reads:
  alias tables over the padded extents (an image without a distribution
  keeps tables of ones) and the pdf normalization (`render/images.py`). A
  scene without images holds one 1x1 white texel."""
  pixels: torch.Tensor         # (I, H, W, 4) float32
  size: torch.Tensor           # (I, 2) int32 true (w, h)
  offset: torch.Tensor         # (I, 2) float32 uv offset (environment maps)
  scale_u: torch.Tensor        # (I,) float32, < 0 mirrors u
  normalization: torch.Tensor  # (I,) float32
  col_ap: torch.Tensor         # (I, H) float32 alias probabilities over rows
  col_ai: torch.Tensor         # (I, H) int32 alias targets
  row_ap: torch.Tensor         # (I, H, W) float32 each row's, over columns
  row_ai: torch.Tensor         # (I, H, W) int32


class Mediums(NamedTuple):
  """Participating media, one row each (a scene without media has one row of
  class 0). `grid` holds every heterogeneous medium's density grid,
  normalised to a maximum of 1 and padded to the largest grid's shape (a
  1-voxel grid of ones when no medium has one)."""
  cls: torch.Tensor              # (D,) int32: 0 none, 1 homogeneous, 2 heterogeneous
  absorption_spec: torch.Tensor  # (D,) int32 spectrum bank row
  scattering_spec: torch.Tensor  # (D,) int32
  phase_g: torch.Tensor          # (D,) float32 Henyey-Greenstein asymmetry
  max_sigma: torch.Tensor        # (D,) float32 majorant: max scattering + max absorption
  grid: torch.Tensor             # (D, gz, gy, gx) float32 density
  bounds_min: torch.Tensor       # (D,3) the grid's box
  bounds_max: torch.Tensor       # (D,3)
  explicit_connections: torch.Tensor  # (D,) int32: NEE from points in the medium


class BVH(NamedTuple):
  """The tables the BVH kernels read (`ops/bvh_build.kernel_tables`, built
  once when the scene is frozen, so no trace call builds a table), on the
  scene's device. The tree itself, in the JAX package's layout, stays in
  the scene's numpy arrays (`SceneBuilder.arrays`)."""
  node_table: torch.Tensor  # (N,8) int32: min(3), max(3) as float32 bits, a leaf's
                            # first triangle row or an inner node's skip, count
  fat_table: Optional[torch.Tensor]  # (Ni,16) int32: fat rows, boxes as float32
                                     # bits, L_first, R_first, counts, skip as int32
  prim_tris: torch.Tensor   # (T,12) float32: v0, e1, e2 of prim_index[j], its
                            # id as int32 bits, 2 zeros


def without_fat_rows(bvh: BVH) -> BVH:
  """The tree without its fat-row form: the trace dispatch then takes the
  plain-node kernels K7/K8, as the JAX package does for such a tree."""
  return bvh._replace(fat_table=None)


class DeviceScene(NamedTuple):
  """The frozen device scene. Every scene carries its BVH: the trace
  dispatch walks it above 4096 triangles, and the brute-force and pair-tile
  kernels ignore it below. `spec_at_wl` is set only inside a spectral
  bounce: (the bounce's wavelength tensor, every SPD at each lane's
  wavelength (R, S)), which `render/spectral.query_spd` reads for queries at
  that very wavelength tensor. `material_features` holds host facts fixed
  when the scene is frozen (`scene/packed.material_features`): the
  material image columns ("scattering_img", ...) that some material uses,
  and "thinfilm" where some material has a thin film."""
  tri_v0: torch.Tensor      # (T,3) Möller-Trumbore arrays
  tri_e1: torch.Tensor      # (T,3)
  tri_e2: torch.Tensor      # (T,3)
  tri_table: torch.Tensor   # (T,39) per-triangle shading rows (scene/packed.py)
  mat_table: torch.Tensor   # (M,32) packed material rows
  em_table: torch.Tensor    # (E,6) packed emitter rows
  prof_table: torch.Tensor  # (P,9) packed emitter-profile rows
  emitters: Emitters
  spec_values: torch.Tensor  # (S,441) spectrum bank on the 1 nm grid
  spec_rgb: torch.Tensor    # (S,3) spectrum bank rows as RGB
  camera: Camera
  bsphere_center: torch.Tensor  # (3,) centre of the vertices' bounding box
  bsphere_radius: torch.Tensor  # () farthest vertex from it (at least 1e-3)
  mediums: Mediums
  radiance_clamp: torch.Tensor  # () float32: a sample's luminance cap, 0: none
  images: ImageBank
  bvh: Optional[BVH] = None
  spec_at_wl: Optional[tuple] = None
  material_features: tuple = ()


@dataclasses.dataclass(frozen=True)
class SceneConfig:
  """Static render configuration (the JAX SceneConfig's fields that the port
  reads; `scene_bridge.check_supported` rejects a configuration it cannot
  render)."""
  film_width: int = 640
  film_height: int = 640
  spectral: bool = False
  samples: int = 256
  max_path_length: int = 65535
  rr_start: int = 6
  # material classes present: dispatch runs only these lobes
  material_classes: tuple = (0,)
  # "blackman-harris" (iteration 0 renders pixel centers), "box" or "center"
  pixel_filter: str = "blackman-harris"
  has_media: bool = False
  has_subsurface: bool = False
  # subsurface classes present (1 RandomWalk, 2 ChristensenBurley)
  subsurface_classes: tuple = (1,)
  # a radiance clamp is set (it turns deferred NEE off, as media do)
  has_radiance_clamp: bool = False
  # adaptive sampling (`models/vcm.render_adaptive`): a pixel stops taking
  # camera samples once its relative noise estimate falls below this
  noise_threshold: float = 0.1
  # distant emitters of weight > 0 (missed rays add their radiance)
  has_env_emitters: bool = False
  num_env_emitters: int = 0
  # the scene holds images (an environment map, a sun disk, a lens shape)
  has_images: bool = False
  # emitter classes present: NEE runs only these branches
  emitter_classes: tuple = (0,)
  # panoramic camera: NDC uv maps to longitude and latitude
  equirectangular: bool = False
  # blue-noise-rotated R2 samples for the first bounce's BSDF and emitter draws
  blue_noise: bool = False
  # diffuse variations present (0 Lambert, 1 the Heitz rough-diffuse walk,
  # 2 the vMF rough diffuse): the Diffuse lobe runs only these
  diffuse_variations: tuple = (0,)
  # the stochastic alpha test runs (some material has an opacity below 1 or
  # a scattering image with an alpha below 1)
  has_alpha: bool = False
  # the validating build: finite checks after each integrator stage
  # (`utils/validate.py`), one host read each
  validate: bool = False


def _to(x, device):
  if isinstance(x, torch.Tensor):
    return x.to(device)
  if isinstance(x, tuple) and hasattr(x, "_fields"):
    return type(x)(*(_to(v, device) for v in x))
  return x


def to_device(scene: DeviceScene, device) -> DeviceScene:
  """The scene with every tensor on `device` (no copy where it already is)."""
  return _to(scene, torch.device(device))


def bvh_from_arrays(arrays, device) -> BVH:
  """The BVH from numpy arrays keyed "bvh.node_table", "bvh.fat_table" (may
  be absent: a tree without fat rows) and "bvh.prim_tris"."""
  device = torch.device(device)

  def t(name):
    return torch.from_numpy(np.array(arrays[f"bvh.{name}"], copy=True)).to(device)

  fat = t("fat_table") if arrays.get("bvh.fat_table") is not None else None
  return BVH(node_table=t("node_table"), fat_table=fat, prim_tris=t("prim_tris"))


def scene_from_arrays(arrays, device) -> DeviceScene:
  """Build a DeviceScene from numpy arrays keyed by dotted field path
  ("tri_v0", "camera.position", "emitters.cdf", "mediums.grid",
  "images.pixels", "bvh.node_table", ...; `bvh_from_arrays`). Extra keys
  are ignored; a missing key raises KeyError, but for "bvh.fat_table" and
  the "images." fields, which default to the bank of a scene without
  images."""
  device = torch.device(device)

  def t(name):
    return torch.from_numpy(np.array(arrays[name], copy=True)).to(device)

  def sub(cls, prefix):
    return cls(**{f: t(f"{prefix}.{f}") for f in cls._fields})

  if "images.pixels" not in arrays:
    arrays = {**arrays, **{f"images.{k}": v for k, v in images_mod.empty_bank().items()}}
  flat = {f: t(f) for f in DeviceScene._fields
          if f not in ("emitters", "camera", "mediums", "images", "bvh", "spec_at_wl",
                       "material_features")}
  return DeviceScene(emitters=sub(Emitters, "emitters"), camera=sub(Camera, "camera"),
                     mediums=sub(Mediums, "mediums"), images=sub(ImageBank, "images"),
                     bvh=bvh_from_arrays(arrays, device),
                     material_features=packed.material_features(arrays["mat_table"]),
                     **flat)
