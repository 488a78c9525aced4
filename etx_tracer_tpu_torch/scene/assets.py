"""Sample asset generation: write the Cornell box as OBJ+MTL+JSON on disk.

The reference ships bin/assets/cornellbox (minus the OBJ); we generate a
complete asset set in the same dialect so the OBJ/MTL/JSON loaders have a
canonical target and users get a runnable example scene.

Counterpart of `etx_tracer_tpu/scene/assets.py`: the same three files,
byte for byte.
"""

from __future__ import annotations

import os

from etx_tracer_tpu_torch.scene import cornell


def write_cornell_asset(directory: str):
  os.makedirs(directory, exist_ok=True)
  b = cornell.build_cornell_box()

  # OBJ: dump merged geometry with per-mesh usemtl
  obj_path = os.path.join(directory, "cornellbox.obj")
  with open(obj_path, "w") as f:
    f.write("# generated by etx-tracer-tpu\nmtllib cornellbox.mtl\n")
    base = 1
    for pos, idx, mat in zip(b.positions, b.indices, b.mesh_material):
      name = b.materials[mat].name or f"m{mat}"
      for p in pos:
        f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
      f.write(f"usemtl {name}\n")
      for t in idx:
        f.write(f"f {t[0]+base} {t[1]+base} {t[2]+base}\n")
      base += len(pos)

  # MTL in the reference's extended dialect
  mtl_path = os.path.join(directory, "cornellbox.mtl")
  with open(mtl_path, "w") as f:
    f.write("""newmtl white
material class diffuse
Kd 1.000 1.000 1.000
Pr 0.000
two_sided 1

newmtl gray
material class diffuse
Kd 0.906 0.906 0.906
Pr 0.000
two_sided 1

newmtl red
material class diffuse
Kd 1.000 0.000 0.000
Pr 0.000
two_sided 1

newmtl green
material class diffuse
Kd 0.000 1.000 0.000
Pr 0.000
two_sided 1

newmtl tallBox
material class conductor
int_ior silver
Ks 1.000 1.000 1.000
Pr 0.000
two_sided 1

newmtl light
material class diffuse
Kd 0.000 0.000 0.000
emitter nblackbody 2700 scale 5.0000
two_sided 1
""")

  json_path = os.path.join(directory, "cornellbox.json")
  with open(json_path, "w") as f:
    f.write("""{
  "geometry": "cornellbox.obj",
  "materials": "cornellbox.mtl",
  "samples": 32,
  "max-path-length": 1023,
  "random-termination-start": 6,
  "spectral": false,
  "camera": {
    "class": "perspective",
    "viewport": [640, 640],
    "origin": [0.0, 1.0, 3.82],
    "target": [0.0, 1.0, -6.18],
    "up": [0.0, 1.0, 0.0],
    "fov": 39.597755335771296,
    "clip-near": 0.1,
    "clip-far": 100.0
  }
}
""")
  return json_path
