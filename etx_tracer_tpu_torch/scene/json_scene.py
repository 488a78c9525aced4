"""Scene JSON loader (scene_representation.cxx:679-838).

Counterpart of `etx_tracer_tpu/scene/json_scene.py`.

The scene .json references geometry (OBJ or glTF) and an optional separate
materials file, plus render settings (samples, max-path-length,
random-termination-start, spectral) and a camera block.
"""

from __future__ import annotations

import json
import os

from etx_tracer_tpu_torch.scene.builder import SceneBuilder
from etx_tracer_tpu_torch.scene.obj_loader import ObjSceneLoader


def load_scene(path: str) -> SceneBuilder:
  """Load a scene from .json (or directly from .obj)."""
  if path.endswith(".obj"):
    return ObjSceneLoader().load(path)

  with open(path) as f:
    desc = json.load(f)
  base_dir = os.path.dirname(os.path.abspath(path))

  loader = ObjSceneLoader()
  b = loader.b

  geometry = desc.get("geometry", "")
  materials = desc.get("materials", "")
  mtl_path = os.path.join(base_dir, materials) if materials else None
  geo_path = os.path.join(base_dir, geometry)

  if geometry.endswith(".obj"):
    loader.load(geo_path, mtl_override=mtl_path)
  elif geometry.endswith((".gltf", ".glb")):
    from etx_tracer_tpu_torch.scene.gltf_loader import load_gltf
    load_gltf(geo_path, b)
  else:
    raise ValueError(f"unsupported geometry: {geometry}")

  b.samples = int(desc.get("samples", b.samples))
  b.max_path_length = int(desc.get("max-path-length", b.max_path_length))
  b.min_path_length = int(desc.get("min-path-length", b.min_path_length))
  b.rr_start = int(desc.get("random-termination-start", b.rr_start))
  b.spectral = bool(desc.get("spectral", b.spectral))
  b.radiance_clamp = float(desc.get("radiance-clamp", b.radiance_clamp))
  b.noise_threshold = float(desc.get("noise-threshold", b.noise_threshold))

  cam = desc.get("camera")
  if cam:
    viewport = cam.get("viewport", [1280, 720])
    fov = cam.get("fov", 50.0)
    b.set_camera(
        origin=cam.get("origin", [5.0, 5.0, 5.0]),
        target=cam.get("target", [0.0, 0.0, 0.0]),
        up=cam.get("up", [0.0, 1.0, 0.0]),
        fov=fov, film_size=viewport,
        lens_radius=cam.get("lens-radius", 0.0),
        focal_distance=cam.get("focal-distance", 0.0),
        clip_near=cam.get("clip-near", None),
        clip_far=cam.get("clip-far", None))
    # "class": "eq" -> equirectangular (scene_representation.cxx:730-731)
    if cam.get("class") == "eq":
      b.camera_equirectangular = True
  return b


def save_scene(path: str, builder: SceneBuilder, geometry_file: str, materials_file: str):
  """Save settings back to scene JSON (scene save-back,
  scene_representation.cxx:2502+; MTL save-back lands with the editor)."""
  desc = {
      "geometry": geometry_file,
      "materials": materials_file,
      "samples": builder.samples,
      "max-path-length": builder.max_path_length,
      "min-path-length": builder.min_path_length,
      "random-termination-start": builder.rr_start,
      "spectral": builder.spectral,
      "camera": {
          "class": "eq" if builder.camera_equirectangular else "perspective",
          "viewport": list(builder.film_size),
          "origin": [float(x) for x in builder.camera_origin],
          "target": [float(x) for x in builder.camera_target],
          "up": [float(x) for x in builder.camera_up],
          "fov": builder.camera_fov,
          "lens-radius": builder.lens_radius,
          "focal-distance": builder.focal_distance,
          "clip-near": builder.clip_near,
          "clip-far": builder.clip_far,
      },
  }
  with open(path, "w") as f:
    json.dump(desc, f, indent=2)
