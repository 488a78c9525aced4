"""glTF 2.0 / GLB loader (pure Python, no deps).

Counterpart of `etx_tracer_tpu/scene/gltf_loader.py`, staging the same
scene into the port's `SceneBuilder`; embedded PNG textures decode through
the port's `utils/image_io`.

Mirrors the reference glTF path (scene_representation.cxx:2110-2458): node
transform hierarchy, PBR metallic-roughness materials mapped to Principled,
base-color/metal-rough/normal/emissive textures, KHR_materials_emissive_
strength and KHR_materials_transmission, and perspective cameras.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.scene import types as st
from etx_tracer_tpu_torch.scene.builder import MaterialDesc, SceneBuilder

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_glb(data: bytes):
  magic, version, length = struct.unpack("<III", data[:12])
  assert magic == 0x46546C67, "not a GLB"
  pos = 12
  gltf = None
  binary = b""
  while pos < length:
    chunk_len, chunk_type = struct.unpack("<II", data[pos:pos + 8])
    payload = data[pos + 8:pos + 8 + chunk_len]
    if chunk_type == 0x4E4F534A:  # JSON
      gltf = json.loads(payload)
    elif chunk_type == 0x004E4942:  # BIN
      binary = payload
    pos += 8 + chunk_len
  return gltf, binary


class _Gltf:
  def __init__(self, path: str):
    self.base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
      data = f.read()
    if path.endswith(".glb") or data[:4] == b"glTF":
      self.doc, self.bin = _load_glb(data)
    else:
      self.doc = json.loads(data)
      self.bin = b""
    self._buffers = []
    for buf in self.doc.get("buffers", []):
      uri = buf.get("uri")
      if uri is None:
        self._buffers.append(self.bin)
      elif uri.startswith("data:"):
        self._buffers.append(base64.b64decode(uri.split(",", 1)[1]))
      else:
        with open(os.path.join(self.base_dir, uri), "rb") as f:
          self._buffers.append(f.read())

  def view_bytes(self, view_index: int) -> bytes:
    view = self.doc["bufferViews"][view_index]
    buf = self._buffers[view["buffer"]]
    o = view.get("byteOffset", 0)
    return buf[o:o + view["byteLength"]]

  def image_pixels(self, image_index: int) -> np.ndarray | None:
    """Decode images[i] -> (H,W,4) float32 [0,1], no colour conversion.

    Mirrors the reference's tinygltf image pool fill
    (scene_representation.cxx:2170-2243). PNG decodes through our own
    codec; JPEG sources are skipped (returns None) rather than failing
    the whole load."""
    from etx_tracer_tpu_torch.utils import image_io
    img = self.doc["images"][image_index]
    if "bufferView" in img:
      data = self.view_bytes(img["bufferView"])
    else:
      uri = img.get("uri", "")
      if uri.startswith("data:"):
        data = base64.b64decode(uri.split(",", 1)[1])
      else:
        with open(os.path.join(self.base_dir, uri), "rb") as f:
          data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
      return image_io.decode_png(data)
    # JPEG/WebP: unsupported codec. Most real-world assets ship JPEG
    # baseColor maps, so be loud about why the material renders untextured.
    import sys
    kind = "JPEG" if data[:2] == b"\xff\xd8" else "unknown-codec"
    print(f"etx-tracer-tpu: glTF image #{image_index} "
          f"({img.get('uri', img.get('name', 'embedded'))}): {kind} "
          "textures are not supported; texture skipped", file=sys.stderr)
    return None

  def accessor(self, index: int) -> np.ndarray:
    acc = self.doc["accessors"][index]
    view = self.doc["bufferViews"][acc["bufferView"]]
    buf = self._buffers[view["buffer"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
      out = np.zeros((count, ncomp), dtype)
      for i in range(count):
        o = offset + i * stride
        out[i] = np.frombuffer(buf, dtype, ncomp, o)
      arr = out
    else:
      arr = np.frombuffer(buf, dtype, count * ncomp, offset).reshape(count, ncomp)
    return arr.copy()


def _node_matrix(node: dict) -> np.ndarray:
  if "matrix" in node:
    return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
  m = np.eye(4)
  t = node.get("translation", [0, 0, 0])
  r = node.get("rotation", [0, 0, 0, 1])
  s = node.get("scale", [1, 1, 1])
  x, y, z, w = r
  rot = np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
      [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
  ])
  m[:3, :3] = rot @ np.diag(s)
  m[:3, 3] = t
  return m


def load_gltf(path: str, builder: SceneBuilder | None = None) -> SceneBuilder:
  b = builder or SceneBuilder()
  g = _Gltf(path)
  doc = g.doc

  # ---- textures: decode once per (source image, content kind) ----
  # glTF stores metallic-roughness packed into one linear image (G =
  # roughness, B = metalness). The reference keeps the packed image and a
  # per-slot channel select (scene_representation.cxx:2277-2283); on TPU
  # the material row carries no channel field, so the split happens at
  # load time into two greyscale images — identical lookups, channel 0.
  textures = doc.get("textures", [])
  _tex_cache: dict = {}

  def tex_image(tex_index: int, kind: str) -> int:
    """builder image index for textures[tex_index], or -1.

    kind: 'srgb' (baseColor/emissive), 'linear' (normal), 'rough'/'metal'
    (G/B greyscale splits of a metallicRoughness image), 'trans' (R)."""
    if tex_index is None or tex_index < 0 or tex_index >= len(textures):
      return -1
    src = textures[tex_index].get("source", -1)
    if src < 0:
      return -1
    key = (src, kind)
    if key in _tex_cache:
      return _tex_cache[key]
    from etx_tracer_tpu_torch.utils import image_io
    if (src, "raw") in _tex_cache:
      pixels = _tex_cache[(src, "raw")]
    else:
      pixels = g.image_pixels(src)
      _tex_cache[(src, "raw")] = pixels
    if pixels is None:
      _tex_cache[key] = -1
      return -1
    if kind == "srgb":
      pixels = image_io.srgb_image_to_linear(pixels)
    elif kind in ("rough", "metal", "trans"):
      ch = {"trans": 0, "rough": 1, "metal": 2}[kind]
      grey = pixels[..., ch:ch + 1]
      if kind == "rough":
        # material rows store GGX alpha = roughness^2; the scalar factor is
        # squared at import below, so squaring the texel keeps
        # alpha = (factor * texel)^2 exactly
        grey = grey * grey
      pixels = np.concatenate([grey, grey, grey,
                               np.ones_like(grey)], -1).astype(np.float32)
    idx = b.add_image(pixels)
    _tex_cache[key] = idx
    return idx

  # ---- materials: PBR metallic-roughness -> Principled ----
  mat_map: list[int] = []
  for gm in doc.get("materials", []):
    pbr = gm.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    metallic = pbr.get("metallicFactor", 1.0)
    roughness = pbr.get("roughnessFactor", 1.0)
    ext = gm.get("extensions", {})
    emissive = np.asarray(gm.get("emissiveFactor", [0, 0, 0]), np.float32)
    if "KHR_materials_emissive_strength" in ext:
      emissive = emissive * ext["KHR_materials_emissive_strength"].get("emissiveStrength", 1.0)
    transmission = 0.0
    trans_img = -1
    if "KHR_materials_transmission" in ext:
      transmission = ext["KHR_materials_transmission"].get("transmissionFactor", 0.0)
      trans_img = tex_image(
          ext["KHR_materials_transmission"].get("transmissionTexture", {}).get("index", -1),
          "trans")

    base_img = tex_image(pbr.get("baseColorTexture", {}).get("index", -1), "srgb")
    mr_tex = pbr.get("metallicRoughnessTexture", {}).get("index", -1)
    rough_img = tex_image(mr_tex, "rough")
    metal_img = tex_image(mr_tex, "metal")
    nrm_tex = gm.get("normalTexture", {})
    normal_img = tex_image(nrm_tex.get("index", -1), "linear")
    # only decode the emissive texture when emission is actually on
    # (emissiveFactor defaults to [0,0,0]); a decoded-but-unused image would
    # permanently bloat the padded (I,H,W,4) device bank
    emis_img = -1
    if float(np.max(emissive)) > 0.0:
      emis_img = tex_image(gm.get("emissiveTexture", {}).get("index", -1), "srgb")

    scattering = b.add_rgb_reflectance(base[:3])
    desc = MaterialDesc(
        name=gm.get("name", f"gltf_{len(mat_map)}"),
        cls=st.MaterialClass.Principled,
        scattering_spec=scattering,
        scattering_img=base_img,
        reflectance_spec=1,
        reflectance_img=base_img,
        roughness=(roughness ** 2, roughness ** 2),
        roughness_img=rough_img,
        metalness=float(metallic),
        metalness_img=metal_img,
        transmission=float(transmission),
        transmission_img=trans_img,
        normal_img=normal_img,
        normal_scale=float(nrm_tex.get("scale", 1.0)) if normal_img >= 0 else 1.0,
        two_sided=bool(gm.get("doubleSided", False)))
    if float(np.max(emissive)) > 0.0:
      desc.emission_spec = b.add_spectrum(sp.SpectralDistribution.rgb_luminance(emissive))
      desc.emission_img = emis_img
    mat_map.append(b.add_material(desc))

  default_mat = None

  def get_default_mat():
    nonlocal default_mat
    if default_mat is None:
      default_mat = b.add_material(MaterialDesc(name="gltf_default", scattering_spec=1))
    return default_mat

  # ---- nodes / meshes ----
  def emit_mesh(mesh_index: int, xform: np.ndarray):
    mesh = doc["meshes"][mesh_index]
    nrm_mat = np.linalg.inv(xform[:3, :3]).T
    for prim in mesh.get("primitives", []):
      if prim.get("mode", 4) != 4:
        continue  # triangles only
      attrs = prim["attributes"]
      pos = g.accessor(attrs["POSITION"]).astype(np.float64)
      pos = pos @ xform[:3, :3].T + xform[:3, 3]
      nrm = None
      if "NORMAL" in attrs:
        nrm = g.accessor(attrs["NORMAL"]).astype(np.float64) @ nrm_mat.T
        norms = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = (nrm / np.maximum(norms, 1e-12)).astype(np.float32)
      uv = g.accessor(attrs["TEXCOORD_0"]).astype(np.float32) if "TEXCOORD_0" in attrs else None
      if "indices" in prim:
        idx = g.accessor(prim["indices"]).reshape(-1).astype(np.int32).reshape(-1, 3)
      else:
        idx = np.arange(pos.shape[0], dtype=np.int32).reshape(-1, 3)
      mat = mat_map[prim["material"]] if "material" in prim else get_default_mat()
      b.add_mesh(pos.astype(np.float32), idx, mat, normals=nrm, uvs=uv)

  def visit(node_index: int, parent: np.ndarray):
    node = doc["nodes"][node_index]
    xform = parent @ _node_matrix(node)
    if "mesh" in node:
      emit_mesh(node["mesh"], xform)
    if "camera" in node:
      cam = doc["cameras"][node["camera"]]
      if cam.get("type") == "perspective":
        p = cam["perspective"]
        origin = xform[:3, 3]
        direction = -xform[:3, 2]
        up = xform[:3, 1]
        yfov = np.rad2deg(p.get("yfov", 0.8))
        aspect = p.get("aspectRatio", b.film_size[0] / b.film_size[1])
        # our fov convention is horizontal
        xfov = np.rad2deg(2.0 * np.arctan(np.tan(np.deg2rad(yfov) / 2.0) * aspect))
        b.set_camera(origin, origin + direction, up, xfov, b.film_size)
    for child in node.get("children", []):
      visit(child, xform)

  scene_index = doc.get("scene", 0)
  scenes = doc.get("scenes", [{}])
  for root in scenes[scene_index].get("nodes", []):
    visit(root, np.eye(4))
  return b
