"""The port's scene-file loaders against the JAX package (CPU).

The Cornell asset writer gives the JAX package's three files byte for
byte; the JSON, OBJ/MTL and glTF loaders stage the same scene into the
port's builder as into the JAX package's, and both freeze bit-identical
tables, compared field by field with the JAX DeviceScene's leaves: the
Cornell scene files; an OBJ/MTL scene with every `et::` directive (camera
with a lens image and a medium, medium with a density grid, directional and
environment emitters, a spectrum file, the atmosphere) and a material of
each parameter (sRGB Kd, textures, a normal map, conductor and dielectric
IORs by name, value and file, thin film, subsurface, emitters, opacity,
`base`); a GLB and a .gltf with embedded PNG textures.

The JAX OBJ loader parses OBJ records with its native library when that
loads; the port copies the Python parse. The tables are compared with the
JAX Python parse (the native parser turned off, and the JAX BVH pinned to
the numpy builder), and the native parse is held to the Python parse on
the same files (ROADMAP Queue 3, watch list). The image banks are built by
the JAX package's native alias builder, which the port copies.
"""

import dataclasses
import json
import os
import struct

import numpy as np
import pytest

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu_torch import native as pnative
from etx_tracer_tpu.scene import assets as jassets
from etx_tracer_tpu.scene import gltf_loader as jgltf
from etx_tracer_tpu.scene import json_scene as jjson
from etx_tracer_tpu.scene import obj_loader as jobj
from etx_tracer_tpu.utils import image_io as jio
from etx_tracer_tpu_torch.scene import assets as passets
from etx_tracer_tpu_torch.scene import gltf_loader as pgltf
from etx_tracer_tpu_torch.scene import json_scene as pjson
from etx_tracer_tpu_torch.scene import obj_loader as pobj
from etx_tracer_tpu_torch.scene import types as ptypes
from tests import nvdb_writer
from tests.test_gltf import _make_glb
from tests.test_torch_images import load_native
from tests.test_torch_render import _jax_arrays
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

# builder settings a scene file sets, compared before the build
BUILDER_FIELDS = ("film_size", "samples", "max_path_length", "min_path_length", "rr_start",
                  "spectral", "radiance_clamp", "noise_threshold", "camera_fov", "lens_radius",
                  "focal_distance", "clip_near", "clip_far", "camera_medium",
                  "camera_lens_image", "camera_equirectangular", "material_names",
                  "medium_names")


@pytest.fixture(autouse=True)
def python_parse_numpy_tree(monkeypatch):
  """The JAX side parses OBJ records in Python and builds the numpy BVH."""
  load_native()
  monkeypatch.setattr(jnative, "parse_obj_native", lambda *a, **k: None)
  monkeypatch.setattr(pnative, "parse_obj_native", lambda *a, **k: None)
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)


def _builders_equal(pb, jb):
  for name in BUILDER_FIELDS:
    assert getattr(pb, name) == getattr(jb, name), name
  for name in ("camera_origin", "camera_target", "camera_up"):
    np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name), err_msg=name)
  assert [dataclasses.asdict(m) for m in pb.materials] == \
      [dataclasses.asdict(m) for m in jb.materials]


def assert_tables_equal(pb, jb):
  """The port builder's frozen arrays and config equal the JAX builder's
  DeviceScene and config, field by field (values and dtypes)."""
  _builders_equal(pb, jb)
  arrays, config = pb.arrays()
  jscene, jconfig = jb.build()
  want = _jax_arrays(jscene)
  assert set(arrays) <= set(want), set(arrays) - set(want)
  for name in arrays:
    got, w = np.asarray(arrays[name]), want[name]
    assert got.shape == w.shape, name
    assert got.dtype == w.dtype, name
    np.testing.assert_array_equal(got, w, err_msg=name)
  for f in dataclasses.fields(ptypes.SceneConfig):
    assert getattr(config, f.name) == getattr(jconfig, f.name), f.name
  return arrays, config


def _files(directory):
  return {n: open(os.path.join(directory, n), "rb").read() for n in sorted(os.listdir(directory))}


def test_cornell_asset_files_equal_jax(tmp_path):
  p = passets.write_cornell_asset(str(tmp_path / "port"))
  j = jassets.write_cornell_asset(str(tmp_path / "jax"))
  assert os.path.basename(p) == os.path.basename(j) == "cornellbox.json"
  got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
  assert list(got) == ["cornellbox.json", "cornellbox.mtl", "cornellbox.obj"]
  assert got == want


@pytest.mark.parametrize("entry", ["json", "obj"])
def test_cornell_scene_files_freeze_jax_tables(tmp_path, entry):
  path = passets.write_cornell_asset(str(tmp_path))
  if entry == "obj":
    path = path.replace(".json", ".obj")
  pb, jb = pjson.load_scene(path), jjson.load_scene(path)
  assert pb.film_size == ((640, 640) if entry == "json" else (1280, 720))
  pb.film_size = jb.film_size = (16, 16)
  arrays, config = assert_tables_equal(pb, jb)
  assert arrays["tri_v0"].shape == (36, 3) and config.material_classes == (0, 3)
  assert (arrays["tri_table"][:, 4] >= 0).sum() == 2  # the light's two triangles


def _write_scene(d):
  """An OBJ/MTL scene with every directive and material parameter the
  loader reads, its image, grid and spectrum files beside it."""
  rs = np.random.default_rng(11)
  jio.save_png(str(d / "albedo.png"), rs.random((4, 6, 3)).astype(np.float32))
  jio.save_png(str(d / "normal.png"), 0.5 + 0.2 * rs.random((4, 4, 3)).astype(np.float32),
               tonemap=False)
  jio.save_png(str(d / "rough.png"), rs.random((2, 2, 3)).astype(np.float32), tonemap=False)
  jio.save_png(str(d / "bokeh.png"), rs.random((8, 8, 3)).astype(np.float32), tonemap=False)
  jio.save_exr(str(d / "env.exr"), 2.0 * rs.random((8, 16, 3)).astype(np.float32))
  np.save(str(d / "grid.npy"), rs.random((3, 4, 5)).astype(np.float32))
  (d / "glass.spd").write_text("#class:dielectric\n400 1.52\n550 1.50\n700 1.49\n")
  (d / "warm.spd").write_text("#class:reflectance\n400 0.2\n550 0.5\n700 0.9\n")
  (d / "scene.mtl").write_text("""
newmtl et::spectrum
id warm
file warm.spd

newmtl et::medium
id fog
scattering 0.8 0.7 0.6
absorption 0.05
g 0.3

newmtl et::medium
id smoke
volume grid.npy
absorbtion 0.1 0.2 0.3
scattering 2.0
anisotropy -0.2
enclosed

newmtl et::camera
origin 0 1 4
target 0 1 0
up 0 1 0
viewport 32 24
focal-length 50
lens-radius 0.05
focal-distance 4
shape bokeh.png
ext_medium fog

newmtl et::env
image env.exr
rotation 90
scale 2
color 0.5 0.6 0.7

newmtl et::dir
direction 0 0.866 0.5
color nblackbody 5800 scale 1.0
angular_diameter 0.53

newmtl floor
material class diffuse
Kd 0.906 0.5 0.2
map_Kd albedo.png
normalmap image normal.png scale 0.5
diffuse 1
two_sided 1

newmtl metal
material class conductor
int_ior silver
Ks 1 1 1
Pr 0.3 0.5
map_Pr rough.png

newmtl coated
base metal
material class principled
Kd warm
metalness 0.25
transmission 0.5
thinfilm range 200 400 ior 1.33
opacity 0.75

newmtl glass
material class dielectric
int_ior glass.spd
ext_ior 1.1
Kt 1 1 1
int_medium smoke

newmtl skin
material class diffuse
Kd 0.8 0.6 0.5
subsurface class approximate distances 0.5 0.25 0.1 scale 0.2

newmtl lamp
Kd 0 0 0
emitter twosided collimated 0.9 color 4 3 2 scale 2

newmtl bulb
Ke blackbody 3000 scale 0.01

newmtl fogbox
material class boundary
int_medium fog
""")
  (d / "scene.obj").write_text("""mtllib scene.mtl
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
v 0 1 0
v 0.5 1.5 0.2
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
vn 0.1 0.9 0.1
f 1 2 5
usemtl floor
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl metal
f 1//2 3//2 5//2
usemtl coated
f 2/2 4/4 6/3
usemtl glass
f -1 -2 -3
usemtl skin
f 1 3 6
usemtl lamp
f 4 5 6
usemtl bulb
f 2 5 6
usemtl fogbox
f 3 4 5 6
usemtl nowhere
f 1 4 6
""")
  return str(d / "scene.obj")


def test_obj_directives_freeze_jax_tables(tmp_path):
  path = _write_scene(tmp_path)
  pb, jb = pobj.ObjSceneLoader().load(path), jobj.ObjSceneLoader().load(path)
  assert len(pb.images) == len(jb.images) == 5
  for pi, ji in zip(pb.images, jb.images):
    assert {k: v for k, v in pi.items() if k != "pixels"} == \
        {k: v for k, v in ji.items() if k != "pixels"}
    np.testing.assert_array_equal(pi["pixels"], ji["pixels"])
  assert pb.camera_lens_image >= 0 and pb.camera_medium == pb.medium_names["fog"]
  arrays, config = assert_tables_equal(pb, jb)
  assert config.has_media and config.has_subsurface and config.num_env_emitters == 2
  MC = ptypes.MaterialClass
  assert set(config.material_classes) == {MC.Diffuse, MC.Conductor, MC.Dielectric,
                                         MC.Boundary, MC.Principled}


def test_obj_atmosphere_directive_freezes_jax_tables(tmp_path, monkeypatch):
  """`et::atmosphere` stages the sun and the sky (the sky at quality 0.25:
  64x32, the least the loader makes)."""
  (tmp_path / "a.mtl").write_text(
      "newmtl et::atmosphere\ndirection 0.2 0.7 0.4\nquality 0.25\naltitude 100\n"
      "anisotropy 0.7\nrayleigh 1.2\nmie 0.8\nozone 1.1\n\nnewmtl ground\nKd 0.5 0.5 0.5\n")
  (tmp_path / "a.obj").write_text(
      "mtllib a.mtl\nv -5 0 -5\nv 5 0 -5\nv 0 0 5\nusemtl ground\nf 1 2 3\n")
  path = str(tmp_path / "a.obj")
  pb, jb = pobj.ObjSceneLoader().load(path), jobj.ObjSceneLoader().load(path)
  pb.film_size = jb.film_size = (8, 8)
  _, config = assert_tables_equal(pb, jb)
  assert config.emitter_classes == (1, 2) and pb.images[0]["pixels"].shape[:2] == (32, 64)


def _jax_obj_tables(path, native: bool, monkeypatch):
  with monkeypatch.context() as mp:
    if not native:
      mp.setattr(jnative, "parse_obj_native", lambda *a, **k: None)
    b = jobj.ObjSceneLoader().load(path)
    return b, _jax_arrays(b.build()[0])


def test_native_obj_parse_drops_faces_before_the_first_usemtl(tmp_path, monkeypatch):
  """The JAX package's two OBJ parse paths freeze the same tables on the
  Cornell files and on the directives scene without its first face. That
  face comes before any `usemtl`: the Python parse gives it a "default"
  material, the native parse drops it (ROADMAP Queue 3, watch list); the
  port's two parse paths do the same."""
  monkeypatch.undo()
  load_native()
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
  cornell = passets.write_cornell_asset(str(tmp_path / "cornell")).replace(".json", ".obj")
  full = _write_scene(tmp_path)
  text = open(full).read()
  lead = "f 1 2 5\nusemtl floor"
  assert lead in text
  named = str(tmp_path / "named.obj")
  with open(named, "w") as f:
    f.write(text.replace(lead, "usemtl floor"))
  for path in (cornell, named, full):
    assert jnative.parse_obj_native(os.path.abspath(path)) is not None
    nb, native = _jax_obj_tables(path, True, monkeypatch)
    pb, python = _jax_obj_tables(path, False, monkeypatch)
    assert set(native) == set(python)
    if path == full:
      assert "default" in pb.material_names and "default" not in nb.material_names
      assert python["tri_v0"].shape[0] == native["tri_v0"].shape[0] + 1
      assert pobj.ObjSceneLoader().load(path).material_names == nb.material_names
      with monkeypatch.context() as mp:
        mp.setattr(pnative, "parse_obj_native", lambda *a, **k: None)
        assert pobj.ObjSceneLoader().load(path).material_names == pb.material_names
      continue
    for name in python:
      np.testing.assert_array_equal(native[name], python[name], err_msg=f"{path}: {name}")


def test_glb_freezes_jax_tables(tmp_path):
  path = _make_glb(tmp_path)
  pb, jb = pgltf.load_gltf(path), jgltf.load_gltf(path)
  arrays, config = assert_tables_equal(pb, jb)
  assert config.material_classes == (ptypes.MaterialClass.Principled,)
  assert arrays["tri_v0"].shape == (2, 3)


def _data_uri(data: bytes, mime: str) -> str:
  import base64
  return f"data:{mime};base64," + base64.b64encode(data).decode()


def _write_gltf(d):
  """A .gltf whose buffer and four PNG textures are data URIs: base colour,
  metallic-roughness, normal and emissive, with the transmission and
  emissive-strength extensions, a node hierarchy and a camera."""
  rs = np.random.default_rng(3)
  png = [jio.encode_png(rs.random((3, 5, 3)).astype(np.float32), flip=False, tonemap=t)
         for t in (True, False, False, True)]
  pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
  uvs = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
  idx = np.array([0, 1, 2, 2, 1, 3], np.uint32)
  binary = pos.tobytes() + uvs.tobytes() + idx.tobytes()
  doc = {
      "asset": {"version": "2.0"}, "scene": 0,
      "scenes": [{"nodes": [0, 2]}],
      "nodes": [{"children": [1], "rotation": [0, 0.3826834, 0, 0.9238795], "scale": [2, 1, 1]},
                {"mesh": 0, "translation": [0.5, 0, -3]},
                {"camera": 0, "translation": [0, 0.5, 2]}],
      "cameras": [{"type": "perspective", "perspective": {"yfov": 0.6, "aspectRatio": 1.5}}],
      "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                  "indices": 2, "material": 0}]}],
      "materials": [{
          "name": "painted",
          "pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.7, 0.5, 1.0],
                                   "baseColorTexture": {"index": 0},
                                   "metallicRoughnessTexture": {"index": 1},
                                   "metallicFactor": 0.4, "roughnessFactor": 0.6},
          "normalTexture": {"index": 2},
          "emissiveTexture": {"index": 3},
          "emissiveFactor": [0.2, 0.1, 0.05],
          "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 3.0},
                         "KHR_materials_transmission": {"transmissionFactor": 0.3,
                                                        "transmissionTexture": {"index": 1}}}}],
      "textures": [{"source": i} for i in range(4)],
      "images": [{"uri": _data_uri(p, "image/png")} for p in png],
      "accessors": [
          {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
          {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC2"},
          {"bufferView": 2, "componentType": 5125, "count": 6, "type": "SCALAR"}],
      "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 48},
                      {"buffer": 0, "byteOffset": 48, "byteLength": 32},
                      {"buffer": 0, "byteOffset": 80, "byteLength": 24}],
      "buffers": [{"byteLength": len(binary),
                   "uri": _data_uri(binary, "application/octet-stream")}],
  }
  path = d / "painted.gltf"
  path.write_text(json.dumps(doc))
  return str(path)


def test_gltf_with_embedded_textures_freezes_jax_tables(tmp_path):
  path = _write_gltf(tmp_path)
  pb, jb = pgltf.load_gltf(path), jgltf.load_gltf(path)
  assert len(pb.images) == len(jb.images) == 6
  for pi, ji in zip(pb.images, jb.images):
    np.testing.assert_array_equal(pi["pixels"], ji["pixels"])
  arrays, config = assert_tables_equal(pb, jb)
  assert config.has_images and (arrays["tri_table"][:, 4] >= 0).sum() == 2


def test_json_scene_over_gltf_and_save_back_equal_jax(tmp_path):
  _write_gltf(tmp_path)
  desc = {"geometry": "painted.gltf", "samples": 7, "max-path-length": 5,
          "min-path-length": 1, "random-termination-start": 3, "spectral": True,
          "radiance-clamp": 4.0, "noise-threshold": 0.05,
          "camera": {"class": "eq", "viewport": [24, 12], "origin": [0, 1, 3],
                     "target": [0, 0, 0], "up": [0, 1, 0], "fov": 60.0,
                     "lens-radius": 0.0, "focal-distance": 0.0, "clip-near": 0.01,
                     "clip-far": 50.0}}
  path = tmp_path / "scene.json"
  path.write_text(json.dumps(desc))
  pb, jb = pjson.load_scene(str(path)), jjson.load_scene(str(path))
  _, config = assert_tables_equal(pb, jb)
  assert config.spectral and config.equirectangular and config.has_radiance_clamp
  assert (config.film_width, config.film_height, config.samples) == (24, 12, 7)
  p_out, j_out = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
  pjson.save_scene(p_out, pb, "painted.gltf", "")
  jjson.save_scene(j_out, jb, "painted.gltf", "")
  assert open(p_out, "rb").read() == open(j_out, "rb").read()
  with pytest.raises(ValueError, match="unsupported geometry"):
    (tmp_path / "bad.json").write_text(json.dumps({"geometry": "x.ply"}))
    pjson.load_scene(str(tmp_path / "bad.json"))


def test_density_grids_and_nvdb(tmp_path):
  grid = np.random.default_rng(2).random((2, 3, 4)).astype(np.float32)
  vol = tmp_path / "g.vol"
  vol.write_bytes(b"VOL\x03" + struct.pack("<iiiii", 1, 4, 3, 2, 1) + b"\x00" * 24
                  + grid.astype("<f4").tobytes())
  np.testing.assert_array_equal(pobj.load_density_grid(str(vol)), grid)
  np.testing.assert_array_equal(pobj.load_density_grid(str(vol)),
                                jobj._load_density_grid(str(vol)))
  assert pobj.load_density_grid(str(tmp_path / "missing.nvdb")) is None
  cloud = nvdb_writer.write_dense(str(tmp_path / "cloud.nvdb"), np.pad(grid, 1), codec=2)
  np.testing.assert_array_equal(pobj.load_density_grid(cloud), jobj._load_density_grid(cloud))
  np.testing.assert_array_equal(pobj.load_density_grid(cloud), np.pad(grid, 1))
