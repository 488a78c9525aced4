"""OBJ/MTL loader with the reference's extended `et::` directives, and the
density-grid files of heterogeneous media.

Counterpart of `etx_tracer_tpu/scene/obj_loader.py` (the reference's OBJ
path, scene_representation.cxx:1054-2088): geometry from OBJ, materials
from MTL including the extension directives — `et::camera`, `et::env`,
`et::dir`, `et::medium`, `et::spectrum`, `et::atmosphere` pseudo
materials, plus per-material `material class X`, Kd/Ks/Kt (sRGB->linear),
Pr roughness (squared), metalness/transmission, int/ext_ior (value, SPD
name or SPD file), int/ext_medium, thinfilm, subsurface, emitter and
opacity params, textures and normal maps. OBJ records go through the
native parser (`native/obj_parser.cpp`) when its library builds, else
through the Python parse, as in the JAX package; the two freeze the same
tables but where a file that names materials has faces before its first
`usemtl`: the native parse drops them, the Python one gives them a
"default" material.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from etx_tracer_tpu_torch import native
from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.scene import types as st
from etx_tracer_tpu_torch.scene.builder import EmitterProfileDesc, MaterialDesc, MediumDesc, SceneBuilder
from etx_tracer_tpu_torch.scene.ior import IORDatabase, load_spd_file

_CLASS_NAMES = {
    "diffuse": st.MaterialClass.Diffuse,
    "translucent": st.MaterialClass.Translucent,
    "plastic": st.MaterialClass.Plastic,
    "conductor": st.MaterialClass.Conductor,
    "msconductor": st.MaterialClass.Conductor,
    "dielectric": st.MaterialClass.Dielectric,
    "msdielectric": st.MaterialClass.Dielectric,
    "thinfilm": st.MaterialClass.Thinfilm,
    "mirror": st.MaterialClass.Mirror,
    "boundary": st.MaterialClass.Boundary,
    "velvet": st.MaterialClass.Velvet,
    "principled": st.MaterialClass.Principled,
    "void": st.MaterialClass.Void,
}


def _srgb_to_linear(v):
  v = np.asarray(v, np.float64)
  return np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)


def _parse_mtl(path: str):
  """MTL -> list of (name, {key: value-string}) preserving order."""
  materials = []
  current = None
  with open(path, errors="replace") as f:
    for raw in f:
      line = raw.strip()
      if not line or line.startswith("#"):
        continue
      parts = line.split(None, 1)
      key = parts[0]
      val = parts[1].strip() if len(parts) > 1 else ""
      if key == "newmtl":
        current = (val, {})
        materials.append(current)
      elif current is not None:
        current[1][key] = val
  return materials


class ObjSceneLoader:
  """Loads OBJ+MTL into a SceneBuilder."""

  def __init__(self, builder: SceneBuilder | None = None):
    self.b = builder or SceneBuilder()
    self.ior_db = IORDatabase()
    self.named_spectra: dict[str, sp.SpectralDistribution] = {}
    self.active_camera_seen = False

  # -- spectra from directive strings (scene_representation.cxx:480-545) --

  def _load_reflectance(self, value: str) -> int:
    parts = value.split()
    if len(parts) == 1 and parts[0] in self.named_spectra:
      return self.b.add_spectrum(self.named_spectra[parts[0]])
    if len(parts) >= 3:
      rgb = _srgb_to_linear([float(parts[0]), float(parts[1]), float(parts[2])])
      return self.b.add_rgb_reflectance(rgb)
    return 0

  def _load_illuminant(self, value: str) -> sp.SpectralDistribution:
    parts = value.split()
    if len(parts) == 1:
      try:
        v = float(parts[0])
        return sp.SpectralDistribution.rgb_luminance([v, v, v])
      except ValueError:
        if parts[0] in self.named_spectra:
          return self.named_spectra[parts[0]]
    if len(parts) == 3:
      return sp.SpectralDistribution.rgb_luminance([float(p) for p in parts])
    spd = sp.SpectralDistribution.rgb_luminance([1.0, 1.0, 1.0])
    scale = 1.0
    i = 0
    while i < len(parts):
      if parts[i] == "blackbody" and i + 1 < len(parts):
        spd = sp.SpectralDistribution.from_black_body(float(parts[i + 1]), 1.0)
        i += 1
      elif parts[i] == "nblackbody" and i + 1 < len(parts):
        spd = sp.SpectralDistribution.from_normalized_black_body(float(parts[i + 1]), 1.0)
        i += 1
      elif parts[i] == "scale" and i + 1 < len(parts):
        scale *= float(parts[i + 1])
        i += 1
      i += 1
    spd.scale(scale)
    return spd

  def _load_ior(self, value: str):
    """-> (cls, eta_idx, k_idx) per the reference load_ior lambda."""
    parts = value.split()
    try:
      vals = [float(p) for p in parts[:2]]
      if len(vals) == 1 or (len(parts) == 1):
        idx = self.b.add_spectrum(sp.SpectralDistribution.constant(
            vals[0], sp.SpectralDistribution.CLASS_DIELECTRIC))
        return sp.SpectralDistribution.CLASS_DIELECTRIC, idx, -1
      if len(vals) == 2:
        e = self.b.add_spectrum(sp.SpectralDistribution.constant(vals[0], sp.SpectralDistribution.CLASS_CONDUCTOR))
        k = self.b.add_spectrum(sp.SpectralDistribution.constant(vals[1], sp.SpectralDistribution.CLASS_CONDUCTOR))
        return sp.SpectralDistribution.CLASS_CONDUCTOR, e, k
    except ValueError:
      pass
    found = self.ior_db.find(parts[0]) if parts else None
    if found is None and parts and os.path.isfile(parts[0]):
      found = load_spd_file(parts[0])
      found = None if found[0] == sp.SpectralDistribution.CLASS_INVALID else found
    if found is None:
      e = self.b.add_spectrum(sp.SpectralDistribution.constant(1.5, sp.SpectralDistribution.CLASS_DIELECTRIC))
      return sp.SpectralDistribution.CLASS_DIELECTRIC, e, -1
    cls, eta, k = found
    e = self.b.add_spectrum(eta)
    kk = self.b.add_spectrum(k) if k is not None else -1
    return cls, e, kk

  # -- et:: pseudo-materials ------------------------------------------------

  def _parse_camera(self, params: dict, base_dir: str = "."):
    active = params.get("active", "1").strip() not in ("0", "false")
    if self.active_camera_seen or not active:
      pass  # only first active camera wins for now
    origin = [float(x) for x in params.get("origin", "5 5 5").split()[:3]]
    target = [float(x) for x in params.get("target", "0 0 0").split()[:3]]
    up = [float(x) for x in params.get("up", "0 1 0").split()[:3]]
    viewport = [int(float(x)) for x in params.get("viewport", "1280 720").split()[:2]]
    fov = float(params.get("fov", "50"))
    if "focal-length" in params:
      fl = float(params["focal-length"])
      # focal_length_to_fov with 36mm film width (Film::kFilmHorizontalSize)
      fov = np.rad2deg(2.0 * np.arctan(0.5 * 36.0 / max(fl, 1e-6)))
      if "fov" in params:
        fov = float(params["fov"])
    self.b.set_camera(origin, target, up, fov, viewport,
                      lens_radius=float(params.get("lens-radius", "0")),
                      focal_distance=float(params.get("focal-distance", "0")),
                      clip_near=float(params.get("clip-near", str(1.0 / 256.0))),
                      clip_far=float(params.get("clip-far", "1024")))
    # panoramic camera (scene_representation.cxx:1057-1059)
    if params.get("class", "").strip() == "eq":
      self.b.camera_equirectangular = True
    # aperture-shape image for bokeh (scene_representation.cxx:1134-1138)
    if "shape" in params:
      path = os.path.join(base_dir, params["shape"].strip())
      if os.path.exists(path):
        self.b.camera_lens_image = self.b.add_image_file(
            path, build_cdf=True, srgb_to_linear=False)
    if "ext_medium" in params:
      self.b.camera_medium = self.b.medium_names.get(params["ext_medium"].strip(), -1)
    if active:
      self.active_camera_seen = True

  def _parse_medium(self, params: dict, base_dir: str):
    name = params.get("id")
    if not name:
      return
    g = float(params.get("g", params.get("anisotropy", "0")))
    s_a = None
    s_t = None

    def rgb_spd(v):
      vals = [float(x) for x in v.split()[:3]]
      if len(vals) == 1:
        vals = vals * 3
      return sp.SpectralDistribution.rgb_reflectance(vals)

    if "absorption" in params:
      s_a = rgb_spd(params["absorption"])
    if "absorbtion" in params:
      s_a = rgb_spd(params["absorbtion"])
    if "scattering" in params:
      s_t = rgb_spd(params["scattering"])

    grid = None
    cls = 1
    if params.get("volume"):
      vol_path = os.path.join(base_dir, params["volume"])
      grid = load_density_grid(vol_path)
      if grid is not None:
        cls = 2

    desc = MediumDesc(
        name=name, cls=cls,
        absorption_spec=self.b.add_spectrum(s_a) if s_a else -1,
        scattering_spec=self.b.add_spectrum(s_t) if s_t else -1,
        phase_g=g, grid=grid,
        explicit_connections="enclosed" not in params)
    self.b.add_medium(desc)

  def _parse_dir_light(self, params: dict):
    spd = self._load_illuminant(params["color"]) if "color" in params \
        else sp.SpectralDistribution.rgb_luminance([1.0, 1.0, 1.0])
    direction = [1.0, 1.0, 1.0]
    if "direction" in params:
      direction = [float(x) for x in params["direction"].split()[:3]]
    ang = np.deg2rad(float(params.get("angular_diameter", "0")))
    self.b.add_distant_emitter(EmitterProfileDesc(
        cls=st.EmitterClass.Directional,
        emission_spec=self.b.add_spectrum(spd),
        direction=tuple(direction), angular_size=float(ang)))

  def _parse_env_light(self, params: dict, base_dir: str):
    spd = self._load_illuminant(params["color"]) if "color" in params \
        else sp.SpectralDistribution.rgb_luminance([1.0, 1.0, 1.0])
    img = -1
    rotation = -float(params.get("rotation", "0")) / 360.0
    u_scale = float(params.get("scale", "1"))
    if params.get("image"):
      path = os.path.join(base_dir, params["image"])
      if os.path.isfile(path):
        img = self.b.add_image_file(path, build_cdf=True, offset=(rotation, 0.0),
                                    u_scale=u_scale, srgb_to_linear=False)
    self.b.add_distant_emitter(EmitterProfileDesc(
        cls=st.EmitterClass.Environment,
        emission_spec=self.b.add_spectrum(spd),
        emission_img=img))

  def _parse_spectrum(self, params: dict, base_dir: str):
    name = params.get("id")
    if not name:
      return
    if "file" in params:
      path = os.path.join(base_dir, params["file"])
      if os.path.isfile(path):
        cls, eta, _ = load_spd_file(path)
        if eta is not None:
          self.named_spectra[name] = eta

  # -- regular materials ------------------------------------------------------

  def _parse_material(self, name: str, params: dict, base_dir: str):
    desc = MaterialDesc(name=name)

    if "base" in params and params["base"] in self.b.material_names:
      import dataclasses as dc
      base = self.b.materials[self.b.material_names[params["base"]]]
      desc = dc.replace(base, name=name)

    if "Kd" in params:
      desc.scattering_spec = self._load_reflectance(params["Kd"])
    if "Ks" in params:
      desc.reflectance_spec = self._load_reflectance(params["Ks"])
    if "Kt" in params:
      desc.scattering_spec = self._load_reflectance(params["Kt"])
    if "two_sided" in params:
      v = params["two_sided"].strip()
      desc.two_sided = v in ("1", "true", "on") or (v.isdigit() and int(v) != 0)
    if "opacity" in params:
      desc.opacity = float(np.clip(float(params["opacity"]), 0.0, 1.0))
    if "Pr" in params:
      vals = [float(x) for x in params["Pr"].split()[:2]]
      if len(vals) == 1:
        vals = vals * 2
      desc.roughness = (vals[0] ** 2, vals[1] ** 2)  # Pr is sqrt(alpha)
    if "metalness" in params:
      desc.metalness = float(params["metalness"].split()[0])
    if "transmission" in params:
      desc.transmission = float(params["transmission"].split()[0])
    if "material" in params:
      toks = params["material"].split()
      for i, t in enumerate(toks):
        if t == "class" and i + 1 < len(toks):
          desc.cls = _CLASS_NAMES.get(toks[i + 1].lower(), st.MaterialClass.Diffuse)
    if "diffuse" in params:
      desc.diffuse_variation = int(float(params["diffuse"].split()[0]))

    # texture maps (map_Kd/map_Ks/map_Kt + map_Pr/map_Ml/map_Tm channels)
    def tex(key, srgb=True):
      if key not in params:
        return -1
      toks = params[key].split()
      path = os.path.join(base_dir, toks[0])
      if os.path.isfile(path):
        return self.b.add_image_file(path, srgb_to_linear=srgb)
      return -1

    m = tex("map_Kd")
    if m >= 0:
      desc.scattering_img = m
    m = tex("map_Ks")
    if m >= 0:
      desc.reflectance_img = m
    m = tex("map_Kt")
    if m >= 0:
      desc.scattering_img = m
    m = tex("map_Pr", srgb=False)
    if m >= 0:
      desc.roughness_img = m
    m = tex("map_Ml", srgb=False)
    if m >= 0:
      desc.metalness_img = m
    m = tex("map_Tm", srgb=False)
    if m >= 0:
      desc.transmission_img = m
    if "normalmap" in params:
      toks = params["normalmap"].split()
      i = 0
      while i < len(toks):
        if toks[i] == "image" and i + 1 < len(toks):
          path = os.path.join(base_dir, toks[i + 1])
          if os.path.isfile(path):
            desc.normal_img = self.b.add_image_file(path, srgb_to_linear=False)
          i += 1
        elif toks[i] == "scale" and i + 1 < len(toks):
          desc.normal_scale = float(toks[i + 1])
          i += 1
        i += 1

    if "int_ior" in params:
      cls, e, k = self._load_ior(params["int_ior"])
      desc.int_ior_cls, desc.int_ior_eta, desc.int_ior_k = cls, e, k
    if "ext_ior" in params:
      _, e, k = self._load_ior(params["ext_ior"])
      desc.ext_ior_eta, desc.ext_ior_k = e, k
    if "int_medium" in params:
      desc.int_medium = self.b.medium_names.get(params["int_medium"].strip(), -1)
    if "ext_medium" in params:
      desc.ext_medium = self.b.medium_names.get(params["ext_medium"].strip(), -1)

    if "diffuse" in params:
      # rough-diffuse variation (scene_representation.cxx:1825-1830)
      try:
        desc.diffuse_variation = int(params["diffuse"].split()[0])
      except (ValueError, IndexError):
        pass

    if "thinfilm" in params:
      toks = params["thinfilm"].split()
      i = 0
      while i < len(toks):
        if toks[i] == "range" and i + 2 < len(toks):
          desc.thinfilm_min = float(toks[i + 1])
          desc.thinfilm_max = float(toks[i + 2])
          i += 2
        elif toks[i] == "ior" and i + 1 < len(toks):
          cls, e, k = self._load_ior(toks[i + 1])
          desc.thinfilm_eta, desc.thinfilm_k = e, k
          i += 1
        i += 1

    if "subsurface" in params:
      desc.subsurface_cls = st.SubsurfaceClass.RandomWalk
      toks = params["subsurface"].split()
      distances = [1.0, 0.2, 0.04]
      scale = 1.0
      i = 0
      while i < len(toks):
        if toks[i] == "path" and i + 1 < len(toks):
          i += 1
        elif toks[i] == "distances" and i + 3 < len(toks):
          distances = [float(toks[i + 1]), float(toks[i + 2]), float(toks[i + 3])]
          i += 3
        elif toks[i] == "scale" and i + 1 < len(toks):
          scale = float(toks[i + 1])
          i += 1
        elif toks[i] == "class" and i + 1 < len(toks):
          if toks[i + 1] == "approximate":
            desc.subsurface_cls = st.SubsurfaceClass.ChristensenBurley
          i += 1
        i += 1
      spd = sp.SpectralDistribution.rgb_reflectance(distances)
      spd.scale(scale)
      desc.subsurface_spec = self.b.add_spectrum(spd)

    # emitter (Ke or `emitter ...` directive)
    emission = None
    scale = 1.0
    if "Ke" in params:
      emission = self._load_illuminant(params["Ke"])
    if "emitter" in params:
      toks = params["emitter"].split()
      i = 0
      while i < len(toks):
        if toks[i] == "twosided":
          desc.two_sided = True
        elif toks[i] == "collimated" and i + 1 < len(toks):
          desc.emission_collimation = float(np.clip(float(toks[i + 1]), 0.0, 1.0))
          i += 1
        elif toks[i] == "color" and i + 3 < len(toks):
          emission = sp.SpectralDistribution.rgb_luminance(
              [float(toks[i + 1]), float(toks[i + 2]), float(toks[i + 3])])
          i += 3
        elif toks[i] == "blackbody" and i + 1 < len(toks):
          emission = sp.SpectralDistribution.from_black_body(float(toks[i + 1]), 1.0)
          i += 1
        elif toks[i] == "nblackbody" and i + 1 < len(toks):
          emission = sp.SpectralDistribution.from_normalized_black_body(float(toks[i + 1]), 1.0)
          i += 1
        elif toks[i] == "scale" and i + 1 < len(toks):
          scale *= float(toks[i + 1])
          i += 1
        i += 1
    if emission is not None:
      emission.scale(scale)
      if emission.luminance() > 0.0:
        desc.emission_spec = self.b.add_spectrum(emission)

    if name in self.b.material_names:
      self.b.materials[self.b.material_names[name]] = desc
    else:
      self.b.add_material(desc)

  # -- OBJ geometry -------------------------------------------------------

  def load(self, obj_path: str, mtl_override: str | None = None) -> SceneBuilder:
    base_dir = os.path.dirname(os.path.abspath(obj_path))

    # the native parser reads the geometry records when its library builds
    parsed = native.parse_obj_native(os.path.abspath(obj_path))
    if parsed is not None:
      return self._load_parsed(parsed, base_dir, mtl_override)

    positions, normals, uvs = [], [], []
    # per-material triangle soup
    mtl_file = mtl_override

    faces = []  # (material_name, [(vi, ti, ni) x3])
    current_mtl = None
    with open(obj_path, errors="replace") as f:
      for raw in f:
        line = raw.strip()
        if not line or line.startswith("#"):
          continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
          positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "vn":
          normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "vt":
          uvs.append([float(parts[1]), float(parts[2])])
        elif tag == "mtllib" and mtl_file is None:
          mtl_file = os.path.join(base_dir, parts[1])
        elif tag == "usemtl":
          current_mtl = parts[1]
        elif tag == "f":
          verts = []
          for tok in parts[1:]:
            comps = tok.split("/")
            vi = int(comps[0])
            ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
            ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
            verts.append((vi, ti, ni))
          for k in range(1, len(verts) - 1):  # fan triangulation
            faces.append((current_mtl, [verts[0], verts[k], verts[k + 1]]))

    # materials first (so medium/spectrum names resolve)
    if mtl_file and os.path.isfile(mtl_file):
      self.load_materials(mtl_file, base_dir)

    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32) if normals else None
    uvs = np.asarray(uvs, np.float32) if uvs else None

    # group faces per material, expand indexed attributes to per-corner verts
    by_mtl: dict[str, list] = {}
    for mtl_name, verts in faces:
      by_mtl.setdefault(mtl_name, []).append(verts)

    for mtl_name, tris in by_mtl.items():
      mat_idx = self.b.material_names.get(mtl_name)
      if mat_idx is None:
        mat_idx = self.b.add_material(MaterialDesc(name=mtl_name or "default",
                                                   scattering_spec=1))
      vpos, vnrm, vuv, vidx = [], [], [], []
      for verts in tris:
        base = len(vpos)
        for (vi, ti, ni) in verts:
          vpos.append(positions[vi - 1 if vi > 0 else vi])
          vnrm.append(normals[ni - 1 if ni > 0 else ni] if (normals is not None and ni != 0) else None)
          vuv.append(uvs[ti - 1 if ti > 0 else ti] if (uvs is not None and ti != 0) else [0.0, 0.0])
        vidx.append([base, base + 1, base + 2])
      has_normals = all(n is not None for n in vnrm)
      self.b.add_mesh(
          np.asarray(vpos, np.float32), np.asarray(vidx, np.int32), mat_idx,
          normals=np.asarray(vnrm, np.float32) if has_normals else None,
          uvs=np.asarray(vuv, np.float32))
    return self.b

  def _load_parsed(self, parsed: dict, base_dir: str, mtl_override: str | None) -> SceneBuilder:
    """Meshes from the native parser's arrays: one a material slot, in order
    of first `usemtl` (a file that names no material: one "default" mesh;
    faces before the first `usemtl` of a file that names some are
    dropped, as in the JAX package's native path)."""
    mtl_file = mtl_override
    if mtl_file is None and parsed["mtllib"]:
      mtl_file = os.path.join(base_dir, parsed["mtllib"])
    if mtl_file and os.path.isfile(mtl_file):
      self.load_materials(mtl_file, base_dir)

    positions, normals, uvs = parsed["positions"], parsed["normals"], parsed["uvs"]
    pos_idx, nrm_idx, uv_idx = parsed["pos_idx"], parsed["nrm_idx"], parsed["uv_idx"]
    tri_mtl = parsed["tri_mtl"]
    names = parsed["mtl_names"]
    for slot in range(max(len(names), 1)):
      if names:
        name = names[slot]
        sel = tri_mtl == slot
      else:
        name = "default"
        sel = np.ones(len(tri_mtl), bool)
      if not sel.any():
        continue
      mat_idx = self.b.material_names.get(name)
      if mat_idx is None:
        mat_idx = self.b.add_material(MaterialDesc(name=name, scattering_spec=1))
      pi, ni, ti = pos_idx[sel], nrm_idx[sel], uv_idx[sel]
      corners = pi.reshape(-1)
      has_normals = (ni >= 0).all() and normals.shape[0] > 0
      vnrm = (normals[np.clip(ni.reshape(-1), 0, max(normals.shape[0] - 1, 0))]
              if has_normals else None)
      vuv = (np.where((ti.reshape(-1) >= 0)[:, None],
                      uvs[np.clip(ti.reshape(-1), 0, max(uvs.shape[0] - 1, 0))], 0.0)
             if uvs.shape[0] > 0 else None)
      idx = np.arange(len(corners), dtype=np.int32).reshape(-1, 3)
      self.b.add_mesh(positions[corners], idx, mat_idx, normals=vnrm, uvs=vuv)
    return self.b

  def load_materials(self, mtl_path: str, base_dir: str | None = None):
    base_dir = base_dir or os.path.dirname(os.path.abspath(mtl_path))
    for name, params in _parse_mtl(mtl_path):
      if name == "et::camera":
        self._parse_camera(params, base_dir)
      elif name == "et::medium":
        self._parse_medium(params, base_dir)
      elif name == "et::dir":
        self._parse_dir_light(params)
      elif name == "et::env":
        self._parse_env_light(params, base_dir)
      elif name == "et::spectrum":
        self._parse_spectrum(params, base_dir)
      elif name == "et::atmosphere":
        self._parse_atmosphere(params)
      else:
        self._parse_material(name, params, base_dir)

  def _parse_atmosphere(self, params: dict):
    """`et::atmosphere` -> precomputed sun + sky emitters
    (scene_representation.cxx:1376-1497)."""
    from etx_tracer_tpu_torch.scene import atmosphere as atm
    direction = [float(x) for x in params.get("direction", "0 1 0").split()[:3]]
    quality = float(params.get("quality", "1"))
    p = atm.Parameters(
        altitude=float(params.get("altitude", "50")),
        anisotropy=float(params.get("anisotropy", "0.75")),
        rayleigh_scale=float(params.get("rayleigh", "1")),
        mie_scale=float(params.get("mie", "1")),
        ozone_scale=float(params.get("ozone", "1")))
    size = max(64, int(256 * quality))
    atm.add_atmosphere(self.b, direction=tuple(direction), params=p,
                       sky_size=(size, size // 2))


def load_density_grid(path: str):
  """A (gz, gy, gx) density array from a NanoVDB float grid (`.nvdb`,
  `.nvdb.gz`; `scene/nvdb.py`), a Mitsuba `.vol` dense grid (float32
  voxels, z-y-x order, the first channel) or a `.npy` array; None when the
  file is missing, not a float32 `.vol`, or a grid the reference clears.
  Grids are normalised to a maximum of 1 when a scene is built, not here."""
  if not os.path.isfile(path):
    return None
  if path.endswith(".npy"):
    return np.load(path)
  if path.endswith(".nvdb") or path.endswith(".nvdb.gz"):
    from etx_tracer_tpu_torch.scene import nvdb
    return nvdb.read_nvdb_density(path)
  if path.endswith(".vol"):
    with open(path, "rb") as f:
      data = f.read()
    if data[:3] != b"VOL":
      return None
    enc, rx, ry, rz, ch = struct.unpack("<iiiii", data[4:24])
    if enc != 1:  # float32 only
      return None
    vals = np.frombuffer(data[48:48 + 4 * rx * ry * rz * ch], "<f4")
    return np.ascontiguousarray(vals.reshape(rz, ry, rx, ch)[..., 0])
  return None
