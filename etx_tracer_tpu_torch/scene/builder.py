"""Host-side scene staging and freezing into the device scene.

Counterpart of `etx_tracer_tpu/scene/builder.py`: every material class
(Diffuse and its variations, Translucent, Plastic, Conductor, Dielectric,
Thinfilm, Mirror, Boundary, Velvet, Principled, Void), material images
(colour, roughness, metalness, transmission and normal maps, an alpha
channel), opacity, subsurface scattering (random walk, Christensen-Burley),
homogeneous and heterogeneous media, a radiance clamp, RGB or spectral
rendering, triangle meshes (with per-vertex normals and uvs when given),
area emitters, distant emitters (environment maps and directional sun
disks), an image bank, and a camera that is a pinhole, a thin lens (its
aperture optionally shaped by an image) or equirectangular, in a medium or
not. Staging and commit-time work (vertex normals, tangent frames, distant
and per-triangle area-emitter instancing, the power-based emitter
distribution, the camera, the spectrum bank, the image bank's alias
tables, the medium table) run in numpy exactly as in the JAX package, so
both packages freeze bit-identical tables, and `ops/bvh_build.py` builds
every scene's tree, natively when its library builds, as the JAX builder
does (`bvh_builder` records which builder it took). `build(device)` adds
the BVH kernels' tables and moves them onto the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from etx_tracer_tpu_torch import resolve_device
from etx_tracer_tpu_torch.core import distribution as distlib
from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.ops import bvh_build
from etx_tracer_tpu_torch.render import images as images_mod
from etx_tracer_tpu_torch.scene import packed
from etx_tracer_tpu_torch.scene import types as st

kInvalid = -1


@dataclasses.dataclass
class MaterialDesc:
  """Host material description with the reference defaults; every field is
  packed into mat_table."""
  name: str = ""
  cls: int = st.MaterialClass.Diffuse
  reflectance_spec: int = kInvalid
  reflectance_img: int = kInvalid
  scattering_spec: int = kInvalid
  scattering_img: int = kInvalid
  emission_spec: int = kInvalid
  emission_img: int = kInvalid
  roughness: tuple = (0.0, 0.0)
  roughness_img: int = kInvalid
  metalness: float = 0.0
  metalness_img: int = kInvalid
  transmission: float = 0.0
  transmission_img: int = kInvalid
  int_ior_eta: int = kInvalid
  int_ior_k: int = kInvalid
  int_ior_cls: int = sp.SpectralDistribution.CLASS_DIELECTRIC
  ext_ior_eta: int = kInvalid
  ext_ior_k: int = kInvalid
  int_medium: int = kInvalid
  ext_medium: int = kInvalid
  normal_img: int = kInvalid
  normal_scale: float = 1.0
  two_sided: bool = False
  opacity: float = 1.0
  emission_collimation: float = 0.0
  diffuse_variation: int = 0
  subsurface_cls: int = st.SubsurfaceClass.Disabled
  subsurface_spec: int = kInvalid
  thinfilm_eta: int = kInvalid
  thinfilm_k: int = kInvalid
  thinfilm_img: int = kInvalid
  thinfilm_min: float = 0.0
  thinfilm_max: float = 0.0


@dataclasses.dataclass
class MediumDesc:
  """Host medium description (the JAX package's defaults)."""
  name: str = ""
  cls: int = 1  # 1 homogeneous, 2 heterogeneous
  absorption_spec: int = kInvalid
  scattering_spec: int = kInvalid
  phase_g: float = 0.0
  grid: Optional[np.ndarray] = None  # (gz, gy, gx) densities
  bounds_min: tuple = (0.0, 0.0, 0.0)
  bounds_max: tuple = (1.0, 1.0, 1.0)
  explicit_connections: bool = True


@dataclasses.dataclass
class EmitterProfileDesc:
  """A distant emitter: an environment (its radiance an image of the bank
  times `emission_spec`, or the spectrum alone) or a directional disk of
  `angular_size` radians about `direction`."""
  cls: int = st.EmitterClass.Environment
  emission_spec: int = kInvalid
  emission_img: int = kInvalid
  direction: tuple = (0.0, 1.0, 0.0)
  angular_size: float = 0.0


class SceneBuilder:
  def __init__(self):
    self.positions: list[np.ndarray] = []
    self.normals: list = []
    self.uvs: list = []
    self.indices: list[np.ndarray] = []
    self.mesh_material: list[int] = []
    self.materials: list[MaterialDesc] = []
    self.material_names: dict[str, int] = {}
    self.spectra: list[sp.SpectralDistribution] = []
    self.mediums: list[MediumDesc] = []
    self.medium_names: dict[str, int] = {}
    self.distant_emitters: list[EmitterProfileDesc] = []
    self.images: list[dict] = []
    self.camera_origin = np.array([5.0, 5.0, 5.0], np.float32)
    self.camera_target = np.zeros(3, np.float32)
    self.camera_up = np.array([0.0, 1.0, 0.0], np.float32)
    self.camera_fov = 26.99
    self.film_size = (1280, 720)
    self.lens_radius = 0.0
    self.focal_distance = 0.0
    self.clip_near = 1.0 / 256.0
    self.clip_far = 1024.0
    self.camera_medium = kInvalid
    self.camera_lens_image = kInvalid
    self.camera_equirectangular = False
    self.samples = 256
    self.max_path_length = 65535
    self.min_path_length = 0
    self.rr_start = 6
    self.radiance_clamp = 0.0
    self.noise_threshold = 0.1
    self.spectral = False
    # which BVH builder staged the scene ("native" or "numpy"), once it is
    # staged (`ops/bvh_build.build_tree`)
    self.bvh_builder: Optional[str] = None

    # spectrum 0 = black, 1 = white; default IORs vacuum 1.0, dielectric 1.5
    self.add_spectrum(sp.SpectralDistribution.null())
    self.add_spectrum(sp.SpectralDistribution.constant(1.0))
    self.vacuum_ior = self.add_spectrum(
        sp.SpectralDistribution.constant(1.0, sp.SpectralDistribution.CLASS_DIELECTRIC))
    self.default_dielectric_ior = self.add_spectrum(
        sp.SpectralDistribution.constant(1.5, sp.SpectralDistribution.CLASS_DIELECTRIC))

  # -- staging ------------------------------------------------------------

  def add_spectrum(self, sd: sp.SpectralDistribution) -> int:
    self.spectra.append(sd)
    return len(self.spectra) - 1

  def add_rgb_reflectance(self, rgb) -> int:
    return self.add_spectrum(sp.SpectralDistribution.rgb_reflectance(np.asarray(rgb, np.float32)))

  def add_rgb_luminance(self, rgb) -> int:
    return self.add_spectrum(sp.SpectralDistribution.rgb_luminance(np.asarray(rgb, np.float32)))

  def add_material(self, desc: MaterialDesc) -> int:
    self.materials.append(desc)
    if desc.name:
      self.material_names[desc.name] = len(self.materials) - 1
    return len(self.materials) - 1

  def add_medium(self, desc: MediumDesc) -> int:
    self.mediums.append(desc)
    if desc.name:
      self.medium_names[desc.name] = len(self.mediums) - 1
    return len(self.mediums) - 1

  def add_distant_emitter(self, desc: EmitterProfileDesc):
    self.distant_emitters.append(desc)

  def add_image(self, pixels: np.ndarray, build_cdf: bool = False,
                offset=(0.0, 0.0), u_scale: float = 1.0, uniform: bool = False) -> int:
    """Stage an (H, W, 4) float image; `build_cdf` gives it a sampling
    distribution (an environment map, a lens shape). Returns its index."""
    self.images.append({
        "pixels": np.asarray(pixels, np.float32),
        "build_cdf": build_cdf, "offset": offset,
        "u_scale": u_scale, "uniform": uniform})
    return len(self.images) - 1

  def add_image_file(self, path: str, build_cdf: bool = False,
                     offset=(0.0, 0.0), u_scale: float = 1.0,
                     srgb_to_linear: bool = True) -> int:
    """Stage an image file (EXR, HDR or PNG; `utils/image_io.load_image`)."""
    from etx_tracer_tpu_torch.utils import image_io
    return self.add_image(image_io.load_image(path, srgb_to_linear),
                          build_cdf=build_cdf, offset=offset, u_scale=u_scale)

  def add_mesh(self, positions, indices, material: int, normals=None, uvs=None):
    self.positions.append(np.asarray(positions, np.float32).reshape(-1, 3))
    self.indices.append(np.asarray(indices, np.int32).reshape(-1, 3))
    self.normals.append(None if normals is None else np.asarray(normals, np.float32).reshape(-1, 3))
    self.uvs.append(None if uvs is None else np.asarray(uvs, np.float32).reshape(-1, 2))
    self.mesh_material.append(material)

  def set_camera(self, origin, target, up, fov, film_size, lens_radius=0.0,
                 focal_distance=0.0, clip_near=None, clip_far=None):
    """Look-at camera; a lens radius and focal distance above kEpsilon give
    depth of field."""
    self.camera_origin = np.asarray(origin, np.float32)
    self.camera_target = np.asarray(target, np.float32)
    self.camera_up = np.asarray(up, np.float32)
    self.camera_fov = float(fov)
    self.film_size = (int(film_size[0]), int(film_size[1]))
    self.lens_radius = float(lens_radius)
    self.focal_distance = float(focal_distance)
    if clip_near is not None:
      self.clip_near = float(clip_near)
    if clip_far is not None:
      self.clip_far = float(clip_far)

  # -- commit ---------------------------------------------------------------

  def _merge_geometry(self):
    all_pos, all_nrm, all_uv, all_idx, all_mat = [], [], [], [], []
    base = 0
    for pos, idx, nrm, uv, mat in zip(self.positions, self.indices, self.normals, self.uvs,
                                      self.mesh_material):
      if nrm is None:
        nrm = _vertex_normals(pos, idx)
      if uv is None:
        uv = np.zeros((pos.shape[0], 2), np.float32)
      all_pos.append(pos)
      all_nrm.append(nrm)
      all_uv.append(uv)
      all_idx.append(idx + base)
      all_mat.append(np.full(idx.shape[0], mat, np.int32))
      base += pos.shape[0]
    if not all_pos:
      raise ValueError("scene has no geometry")
    return (np.concatenate(all_pos), np.concatenate(all_nrm), np.concatenate(all_uv),
            np.concatenate(all_idx), np.concatenate(all_mat))

  def arrays(self):
    """Commit the staged scene: (numpy arrays keyed by dotted DeviceScene
    field path, SceneConfig)."""
    pos, nrm, uv, idx, tri_mat = self._merge_geometry()
    num_t = idx.shape[0]

    v0 = pos[idx[:, 0]]
    e1 = pos[idx[:, 1]] - v0
    e2 = pos[idx[:, 2]] - v0
    geo_n_raw = np.cross(e1, e2)
    twice_area = np.linalg.norm(geo_n_raw, axis=-1)
    tri_area = (0.5 * twice_area).astype(np.float32)
    geo_n = geo_n_raw / np.maximum(twice_area, 1e-20)[:, None]

    tan, btn = _tangents(nrm, uv, idx, pos)

    # bounding sphere
    bb_min = pos.min(axis=0)
    bb_max = pos.max(axis=0)
    center = (bb_min + bb_max) * 0.5
    radius = float(np.linalg.norm(pos - center, axis=-1).max())
    radius = max(radius, 1e-3)

    # ---- emitter instancing: the distant emitters first (weight: their
    # spectrum's luminance over the bounding sphere's disk), then one
    # instance per emissive triangle ----
    mat_emitter_profile: dict[int, int] = {}
    profiles: list[EmitterProfileDesc] = list(self.distant_emitters)
    inst_cls, inst_profile, inst_tri, inst_area = [], [], [], []
    inst_spectrum_w, inst_additional_w = [], []
    for pi, prof in enumerate(self.distant_emitters):
      inst_cls.append(prof.cls)
      inst_profile.append(pi)
      inst_tri.append(kInvalid)
      inst_area.append(0.0)
      inst_spectrum_w.append(self.spectra[prof.emission_spec].luminance()
                             if prof.emission_spec != kInvalid else 0.0)
      inst_additional_w.append(np.pi * radius * radius)

    tri_emitter = np.full(num_t, kInvalid, np.int32)
    for t in range(num_t):
      m = self.materials[tri_mat[t]]
      if m.emission_spec == kInvalid:
        continue
      spectrum_weight = self.spectra[m.emission_spec].luminance()
      additional = (2.0 if m.two_sided else 1.0) * tri_area[t] * np.pi
      if spectrum_weight <= 0.0 or additional <= 0.0:
        continue
      mi = int(tri_mat[t])
      if mi not in mat_emitter_profile:
        mat_emitter_profile[mi] = len(profiles)
        profiles.append(EmitterProfileDesc(cls=st.EmitterClass.Area,
                                           emission_spec=m.emission_spec,
                                           emission_img=m.emission_img))
      tri_emitter[t] = len(inst_cls)
      inst_cls.append(st.EmitterClass.Area)
      inst_profile.append(mat_emitter_profile[mi])
      inst_tri.append(t)
      inst_area.append(float(tri_area[t]))
      inst_spectrum_w.append(spectrum_weight)
      inst_additional_w.append(additional)

    weights = np.asarray([sw * aw for sw, aw in zip(inst_spectrum_w, inst_additional_w)],
                         np.float64)
    if not inst_cls:
      # no emitter at all: one Undefined instance of weight 0
      weights = np.zeros(1)
      inst_cls, inst_profile, inst_tri, inst_area = ([st.EmitterClass.Undefined], [0],
                                                     [kInvalid], [0.0])
    pdf, cdf, total_w = distlib.build(weights)
    env_idx = np.full(64, kInvalid, np.int32)
    env_count = 0
    for i, c in enumerate(inst_cls):
      if c in (st.EmitterClass.Environment, st.EmitterClass.Directional) and weights[i] > 0.0:
        env_idx[env_count] = i
        env_count += 1
    inst_cls = np.asarray(inst_cls, np.int32)
    inst_profile = np.asarray(inst_profile, np.int32)
    inst_tri = np.asarray(inst_tri, np.int32)
    inst_area = np.asarray(inst_area, np.float32)
    weights = weights.astype(np.float32)

    if not profiles:
      profiles = [EmitterProfileDesc(cls=st.EmitterClass.Undefined)]
    prof_cls = np.asarray([p.cls for p in profiles], np.int32)
    prof_spec = np.asarray([p.emission_spec for p in profiles], np.int32)
    prof_img = np.asarray([p.emission_img for p in profiles], np.int32)
    prof_dir = np.asarray([_normalize(p.direction) for p in profiles], np.float32)
    prof_ang = np.asarray([p.angular_size for p in profiles], np.float32)
    prof_disk = 2.0 * np.tan(prof_ang / 2.0)
    prof_cos = np.cos(prof_ang / 2.0)

    # ---- materials, packed ----
    mats = self.materials if self.materials else [MaterialDesc()]

    def marr(fn, dtype):
      return np.asarray([fn(m) for m in mats], dtype)

    def ior_default(v, default):
      return v if v != kInvalid else default

    materials = {
        "cls": marr(lambda m: m.cls, np.int32),
        "reflectance_spec": marr(lambda m: ior_default(m.reflectance_spec, 1), np.int32),
        "reflectance_img": marr(lambda m: m.reflectance_img, np.int32),
        "scattering_spec": marr(lambda m: ior_default(m.scattering_spec, 1), np.int32),
        "scattering_img": marr(lambda m: m.scattering_img, np.int32),
        "roughness": marr(lambda m: m.roughness, np.float32),
        "roughness_img": marr(lambda m: m.roughness_img, np.int32),
        "metalness": marr(lambda m: m.metalness, np.float32),
        "metalness_img": marr(lambda m: m.metalness_img, np.int32),
        "transmission": marr(lambda m: m.transmission, np.float32),
        "transmission_img": marr(lambda m: m.transmission_img, np.int32),
        "int_ior_eta": marr(lambda m: ior_default(m.int_ior_eta, self.default_dielectric_ior), np.int32),
        "int_ior_k": marr(lambda m: m.int_ior_k, np.int32),
        "int_ior_cls": marr(lambda m: m.int_ior_cls, np.int32),
        "ext_ior_eta": marr(lambda m: ior_default(m.ext_ior_eta, self.vacuum_ior), np.int32),
        "ext_ior_k": marr(lambda m: m.ext_ior_k, np.int32),
        "int_medium": marr(lambda m: m.int_medium, np.int32),
        "ext_medium": marr(lambda m: m.ext_medium, np.int32),
        "normal_img": marr(lambda m: m.normal_img, np.int32),
        "normal_scale": marr(lambda m: m.normal_scale, np.float32),
        "two_sided": marr(lambda m: 1 if m.two_sided else 0, np.int32),
        "opacity": marr(lambda m: m.opacity, np.float32),
        "emission_collimation": marr(lambda m: m.emission_collimation, np.float32),
        "diffuse_variation": marr(lambda m: m.diffuse_variation, np.int32),
        "subsurface_cls": marr(lambda m: m.subsurface_cls, np.int32),
        "subsurface_spec": marr(lambda m: m.subsurface_spec, np.int32),
        "thinfilm_eta": marr(lambda m: m.thinfilm_eta, np.int32),
        "thinfilm_k": marr(lambda m: m.thinfilm_k, np.int32),
        "thinfilm_img": marr(lambda m: m.thinfilm_img, np.int32),
        "thinfilm_min": marr(lambda m: m.thinfilm_min, np.float32),
        "thinfilm_max": marr(lambda m: m.thinfilm_max, np.float32),
    }

    arrays = {
        "tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
        "tri_table": packed.build_tri_table(
            pos, nrm, tan, btn, uv, idx, geo_n.astype(np.float32), tri_mat,
            tri_emitter, tri_area),
        "mat_table": packed.pack_materials(materials),
        "em_table": packed.build_emitter_table(inst_cls, inst_profile, inst_tri, weights,
                                               inst_area, pdf),
        "prof_table": packed.build_profile_table(prof_cls, prof_spec, prof_img, prof_dir,
                                                 prof_ang, prof_disk, prof_cos),
        "emitters.pdf": pdf, "emitters.cdf": cdf,
        "emitters.total_weight": np.float32(total_w),
        "emitters.env_indices": env_idx, "emitters.env_count": np.int32(env_count),
        "spec_values": np.stack([s.values for s in self.spectra]).astype(np.float32),
        "spec_rgb": np.stack([s.integrated_rgb() for s in self.spectra]).astype(np.float32),
        "bsphere_center": center.astype(np.float32),
        "bsphere_radius": np.float32(radius),
        "radiance_clamp": np.float32(self.radiance_clamp),
        **_build_mediums(self.mediums, self.spectra),
        **{f"images.{k}": v for k, v in images_mod.build_bank(self.images).items()},
    }
    tree, self.bvh_builder = bvh_build.build_tree(v0, e1, e2)
    arrays.update({f"bvh.{k}": v for k, v in tree.items() if v is not None})
    arrays.update(_build_camera(self.camera_origin, self.camera_target, self.camera_up,
                                self.camera_fov, self.film_size, self.lens_radius,
                                self.focal_distance, self.clip_near, self.clip_far,
                                self.camera_medium, self.camera_lens_image))

    config = st.SceneConfig(
        film_width=self.film_size[0], film_height=self.film_size[1],
        spectral=self.spectral, samples=self.samples,
        max_path_length=min(self.max_path_length, 4096), rr_start=self.rr_start,
        material_classes=tuple(sorted({m.cls for m in mats})),
        has_media=len(self.mediums) > 0,
        has_subsurface=any(m.subsurface_cls != st.SubsurfaceClass.Disabled for m in mats),
        subsurface_classes=tuple(sorted(
            {m.subsurface_cls for m in mats
             if m.subsurface_cls != st.SubsurfaceClass.Disabled})) or (1,),
        has_radiance_clamp=self.radiance_clamp > 0.0, noise_threshold=self.noise_threshold,
        has_env_emitters=env_count > 0, num_env_emitters=env_count,
        has_images=len(self.images) > 0,
        emitter_classes=tuple(sorted({int(c) for c in inst_cls
                                      if c != st.EmitterClass.Undefined})) or (0,),
        equirectangular=self.camera_equirectangular,
        diffuse_variations=tuple(sorted({m.diffuse_variation for m in mats})) or (0,),
        has_alpha=(any(m.opacity < 1.0 for m in mats)
                   or any(m.scattering_img >= 0 and _has_cutout(self.images[m.scattering_img])
                          for m in mats)))
    return arrays, config

  def build(self, device=None):
    """Freeze the scene onto `device` (default: the CUDA card, which must
    exist), with the BVH kernels' tables. Returns (DeviceScene,
    SceneConfig)."""
    device = resolve_device(device)
    arrays, config = self.arrays()
    arrays.update(bvh_build.kernel_tables(arrays))
    return st.scene_from_arrays(arrays, device), config


def _has_cutout(image: dict) -> bool:
  """Whether a staged image has an alpha channel below 1 somewhere."""
  px = image["pixels"]
  return px.ndim == 3 and px.shape[-1] >= 4 and float(px[..., 3].min()) < 1.0


def _normalize(v):
  v = np.asarray(v, np.float32)
  return v / max(np.linalg.norm(v), 1e-20)


def _vertex_normals(pos, idx):
  n = np.zeros_like(pos)
  v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
  face_n = np.cross(v1 - v0, v2 - v0)  # area-weighted
  for k in range(3):
    np.add.at(n, idx[:, k], face_n)
  norm = np.linalg.norm(n, axis=-1, keepdims=True)
  return (n / np.maximum(norm, 1e-20)).astype(np.float32)


def _tangents(nrm, uv, idx, pos):
  """Per-vertex tangent frames; UV-gradient based with a fallback basis."""
  tan = np.zeros_like(nrm)
  v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
  uv0, uv1, uv2 = uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]
  du1 = uv1 - uv0
  du2 = uv2 - uv0
  r = du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]
  ok = np.abs(r) > 1e-12
  rr = np.where(ok, r, 1.0)
  t_face = ((v1 - v0) * du2[:, 1:2] - (v2 - v0) * du1[:, 1:2]) / rr[:, None]
  t_face = np.where(ok[:, None], t_face, 0.0)
  for k in range(3):
    np.add.at(tan, idx[:, k], t_face)
  tan = tan - nrm * np.sum(tan * nrm, axis=-1, keepdims=True)
  ln = np.linalg.norm(tan, axis=-1, keepdims=True)
  fallback = _orthonormal_np(nrm)
  tan = np.where(ln > 1e-8, tan / np.maximum(ln, 1e-20), fallback)
  btn = np.cross(nrm, tan)
  btn /= np.maximum(np.linalg.norm(btn, axis=-1, keepdims=True), 1e-20)
  return tan.astype(np.float32), btn.astype(np.float32)


def _orthonormal_np(n):
  distinct = (n[:, 0] != n[:, 1]) | (n[:, 0] != n[:, 2])
  a = np.where(
      distinct[:, None],
      np.stack([n[:, 2] - n[:, 1], n[:, 0] - n[:, 2], n[:, 1] - n[:, 0]], axis=-1),
      np.stack([n[:, 2] - n[:, 1], n[:, 0] + n[:, 2], -n[:, 1] - n[:, 0]], axis=-1),
  )
  return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)


def _build_camera(origin, target, up, fov_deg, film_size, lens_radius, focal_distance,
                  clip_near, clip_far, medium, lens_image):
  """Look-at camera, in numpy (the JAX package's build)."""
  f = _normalize(np.asarray(target) - np.asarray(origin))
  s = _normalize(np.cross(f, np.asarray(up, np.float32)))
  u = np.cross(s, f)
  w, h = film_size
  fov = np.deg2rad(fov_deg)
  cot = np.cos(0.5 * fov) / np.sin(0.5 * fov)
  aspect = w / h
  tan_half_fov = 1.0 / cot
  view = np.array([
      [s[0], s[1], s[2], -np.dot(s, origin)],
      [u[0], u[1], u[2], -np.dot(u, origin)],
      [-f[0], -f[1], -f[2], np.dot(f, origin)],
      [0, 0, 0, 1],
  ], np.float32)
  zn, zf = clip_near, clip_far
  proj = np.zeros((4, 4), np.float32)
  proj[0, 0] = cot
  proj[1, 1] = cot * aspect
  proj[2, 2] = zf / (zn - zf)
  proj[2, 3] = -(zf * zn) / (zf - zn)
  proj[3, 2] = -1.0
  return {
      "camera.position": np.asarray(origin, np.float32),
      "camera.direction": f.astype(np.float32),
      "camera.side": s.astype(np.float32),
      "camera.up": u.astype(np.float32),
      "camera.view_proj": proj @ view,
      "camera.tan_half_fov": np.float32(tan_half_fov),
      "camera.aspect": np.float32(aspect),
      "camera.area": np.float32((2.0 * tan_half_fov) * (2.0 * tan_half_fov / aspect)),
      "camera.lens_radius": np.float32(lens_radius),
      "camera.focal_distance": np.float32(focal_distance),
      "camera.clip_near": np.float32(clip_near),
      "camera.clip_far": np.float32(clip_far),
      "camera.medium_index": np.int32(medium),
      "camera.lens_image": np.int32(lens_image),
  }


def _build_mediums(descs: list, spectra) -> dict:
  """The medium table, keyed "mediums.<field>": one row a medium (one row
  of class 0 when there is none), every grid normalised to a maximum of 1
  and padded with ones to the largest grid's shape."""
  n = max(len(descs), 1)
  if not descs:
    descs = [MediumDesc(cls=0)]
  gz = max(max((d.grid.shape[0] if d.grid is not None else 1) for d in descs), 1)
  gy = max(max((d.grid.shape[1] if d.grid is not None else 1) for d in descs), 1)
  gx = max(max((d.grid.shape[2] if d.grid is not None else 1) for d in descs), 1)
  grids = np.ones((n, gz, gy, gx), np.float32)
  for i, d in enumerate(descs):
    if d.grid is not None:
      g = d.grid.astype(np.float32)
      m = g.max()
      if m > 0:
        g = g / m
      grids[i, :g.shape[0], :g.shape[1], :g.shape[2]] = g

  def max_sigma(d: MediumDesc):
    s = spectra[d.scattering_spec].maximum_power() if d.scattering_spec != kInvalid else 0.0
    a = spectra[d.absorption_spec].maximum_power() if d.absorption_spec != kInvalid else 0.0
    return s + a

  return {
      "mediums.cls": np.asarray([d.cls for d in descs], np.int32),
      "mediums.absorption_spec": np.asarray([d.absorption_spec for d in descs], np.int32),
      "mediums.scattering_spec": np.asarray([d.scattering_spec for d in descs], np.int32),
      "mediums.phase_g": np.asarray([d.phase_g for d in descs], np.float32),
      "mediums.max_sigma": np.asarray([max_sigma(d) for d in descs], np.float32),
      "mediums.grid": grids,
      "mediums.bounds_min": np.asarray([d.bounds_min for d in descs], np.float32),
      "mediums.bounds_max": np.asarray([d.bounds_max for d in descs], np.float32),
      "mediums.explicit_connections": np.asarray(
          [1 if d.explicit_connections else 0 for d in descs], np.int32),
  }
