"""Scene save-back to extended MTL (scene_representation.cxx:2502-2980).

The port's copy of `etx_tracer_tpu/scene/save_mtl.py`: writes the `et::`
directive vocabulary the loader understands — camera, mediums, distant
emitters and per-material blocks — from a staged SceneBuilder, so edited
scenes round-trip through scene/obj_loader.py. The same builder gives the
JAX package's text byte for byte.
"""

from __future__ import annotations

import numpy as np

from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.scene import types as st

_CLASS_NAMES = {
    st.MaterialClass.Diffuse: "diffuse",
    st.MaterialClass.Translucent: "translucent",
    st.MaterialClass.Plastic: "plastic",
    st.MaterialClass.Conductor: "conductor",
    st.MaterialClass.Dielectric: "dielectric",
    st.MaterialClass.Thinfilm: "thinfilm",
    st.MaterialClass.Mirror: "mirror",
    st.MaterialClass.Boundary: "boundary",
    st.MaterialClass.Velvet: "velvet",
    st.MaterialClass.Principled: "principled",
    st.MaterialClass.Void: "void",
}


def _rgb_of(builder, spec_idx):
  if spec_idx is None or spec_idx < 0 or spec_idx >= len(builder.spectra):
    return None
  rgb = np.asarray(builder.spectra[spec_idx].integrated_rgb())
  return [float(x) for x in rgb]


def _fmt3(v):
  return f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"


def save_materials(path: str, builder) -> None:
  """Write the builder's camera/mediums/materials as an extended MTL."""
  lines: list[str] = []

  # camera block (scene_representation.cxx:2680-2712)
  lines.append("newmtl et::camera")
  lines.append("class " + ("eq" if builder.camera_equirectangular else "perspective"))
  lines.append(f"viewport {builder.film_size[0]} {builder.film_size[1]}")
  lines.append("origin " + _fmt3(builder.camera_origin))
  lines.append("target " + _fmt3(builder.camera_target))
  lines.append("up " + _fmt3(builder.camera_up))
  lines.append(f"fov {builder.camera_fov:.6f}")
  lines.append(f"lens-radius {builder.lens_radius:.6f}")
  lines.append(f"focal-distance {builder.focal_distance:.6f}")
  lines.append(f"clip-near {builder.clip_near:.6f}")
  lines.append(f"clip-far {builder.clip_far:.6f}")
  if builder.camera_medium >= 0:
    for name, idx in builder.medium_names.items():
      if idx == builder.camera_medium:
        lines.append(f"ext_medium {name}")
        break
  lines.append("")

  # mediums (parse_medium counterpart)
  for name, idx in builder.medium_names.items():
    med = builder.mediums[idx]
    lines.append("newmtl et::medium")
    lines.append(f"id {name}")
    a = _rgb_of(builder, med.absorption_spec)
    s = _rgb_of(builder, med.scattering_spec)
    if a is not None:
      lines.append("absorption " + _fmt3(a))
    if s is not None:
      lines.append("scattering " + _fmt3(s))
    if med.phase_g:
      lines.append(f"g {med.phase_g:.6f}")
    lines.append("")

  # distant emitters (et::dir / et::env)
  for prof in builder.distant_emitters:
    if prof.cls == st.EmitterClass.Directional:
      lines.append("newmtl et::dir")
      lines.append("direction " + _fmt3(prof.direction))
      if prof.angular_size:
        lines.append(f"angular_diameter {np.degrees(prof.angular_size):.6f}")
    else:
      lines.append("newmtl et::env")
    rgb = _rgb_of(builder, prof.emission_spec)
    if rgb is not None:
      lines.append("color " + _fmt3(rgb))
    lines.append("")

  # materials (scene_representation.cxx:2800-2980)
  for name, idx in builder.material_names.items():
    if name.startswith("et::"):
      continue
    m = builder.materials[idx]
    lines.append(f"newmtl {name}")
    lines.append("material class " + _CLASS_NAMES.get(m.cls, "diffuse"))
    kd = _rgb_of(builder, m.scattering_spec)
    if kd is not None:
      lines.append("Kd " + _fmt3(kd))
      if m.cls in (st.MaterialClass.Dielectric, st.MaterialClass.Translucent) \
          or m.transmission > 1e-6:
        lines.append("Kt " + _fmt3(kd))
    ks = _rgb_of(builder, m.reflectance_spec)
    if ks is not None:
      lines.append("Ks " + _fmt3(ks))
    ru, rv = m.roughness
    if max(ru, rv) > 1e-6:
      # stored alpha = Pr^2; save back as Pr (the loader squares on read)
      su, sv = np.sqrt(max(ru, 0.0)), np.sqrt(max(rv, 0.0))
      if abs(su - sv) < 1e-6:
        lines.append(f"Pr {su:.6f}")
      else:
        lines.append(f"Pr {su:.6f} {sv:.6f}")
    if m.metalness > 1e-6:
      lines.append(f"metalness {m.metalness:.6f}")
    if m.transmission > 1e-6:
      lines.append(f"transmission {m.transmission:.6f}")
    if m.opacity < 1.0:
      lines.append(f"opacity {m.opacity:.6f}")
    if m.diffuse_variation:
      lines.append(f"diffuse {m.diffuse_variation}")
    if getattr(m, "emission_spec", -1) >= 0:
      em_rgb = _rgb_of(builder, m.emission_spec)
      tok = "emitter"
      if em_rgb is not None:
        tok += " color " + _fmt3(em_rgb)
      if m.two_sided:
        tok += " twosided"
      if m.emission_collimation > 0.0:
        tok += f" collimated {m.emission_collimation:.6f}"
      lines.append(tok)
    if m.int_ior_eta >= 0 and m.int_ior_eta != builder.default_dielectric_ior:
      sd = builder.spectra[m.int_ior_eta]
      eta_mid = float(np.asarray(sd.values).mean()) if hasattr(sd, "values") else None
      if m.int_ior_cls == sp.SpectralDistribution.CLASS_DIELECTRIC and eta_mid:
        lines.append(f"int_ior {eta_mid:.6f}")
    if m.thinfilm_min > 0.0 or m.thinfilm_max > 0.0:
      lines.append(f"thinfilm range {m.thinfilm_min:.6f} {m.thinfilm_max:.6f}")
    if m.subsurface_cls != st.SubsurfaceClass.Disabled:
      tok = "subsurface"
      if m.subsurface_cls == st.SubsurfaceClass.ChristensenBurley:
        tok += " class approximate"
      lines.append(tok)
    for n2, i2 in builder.medium_names.items():
      if i2 == m.int_medium:
        lines.append(f"int_medium {n2}")
      if i2 == m.ext_medium:
        lines.append(f"ext_medium {n2}")
    lines.append("")

  with open(path, "w") as f:
    f.write("\n".join(lines))
