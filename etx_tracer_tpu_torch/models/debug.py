"""Debug integrator: single-bounce AOV visualisations.

Counterpart of `etx_tracer_tpu/models/debug.py` (the reference's
CPUDebugIntegrator, rt/integrators/debug.cxx:28-46): the geometry and
shading oracle used to validate loaders and shading frames. One camera ray
a pixel at iteration 0, one closest-hit trace for the whole image (K1 on a
scene of at most 128 triangles), no light transport. Two modes trace
nothing: the spectral-pipeline plot and the thin-film response curve.
"""

from __future__ import annotations

import numpy as np
import torch

from etx_tracer_tpu_torch import resolve_device
from etx_tracer_tpu_torch.core import math as em
from etx_tracer_tpu_torch.core import rng
from etx_tracer_tpu_torch.core import spectrum as sp
from etx_tracer_tpu_torch.models import path_tracing as pt
from etx_tracer_tpu_torch.ops import trace as trace_ops
from etx_tracer_tpu_torch.render import spectral as spx
from etx_tracer_tpu_torch.render.bsdf import common as bsdf_common
from etx_tracer_tpu_torch.render.bsdf import dispatch as bsdf_dispatch
from etx_tracer_tpu_torch.render.bsdf import lobes
from etx_tracer_tpu_torch.scene import packed
from etx_tracer_tpu_torch.scene import spectral_data
from etx_tracer_tpu_torch.scene import types as st


class DebugMode:
  Barycentrics = 0
  Normals = 1
  Tangents = 2
  Bitangents = 3
  TexCoords = 4
  GeometricNormals = 5
  FaceOrientation = 6
  Depth = 7
  MaterialIndex = 8
  Albedo = 9
  Fresnel = 10
  EmitterIndex = 11
  TransmittanceColor = 12
  ReflectanceColor = 13
  IOR = 14
  Random = 15
  Spectrums = 16
  ThinfilmCurve = 17
  Count = 18


# stratified wavelength samples a pixel of the two plots
_PLOT_SAMPLES = 8


def _pixels(config, device):
  w, h = config.film_width, config.film_height
  pix = torch.arange(w * h, dtype=torch.int64, device=device)
  return pix, pix % w, pix // w


def _render_spectrums(config, device):
  """Spectral-pipeline plot: 9 horizontal bands of canonical SPDs (blackbody
  series, D65, constant, RGB-upsampled reflectance and luminance), each
  normalised to unit luminance; the LEFT half is the one-wavelength
  spectral estimate (8 stratified samples a pixel, sech^2 sampler, /pdf,
  CIE -> RGB), the RIGHT half the RGB integration path."""
  w, h = config.film_width, config.film_height
  spds = [
      sp.SpectralDistribution.from_normalized_black_body(2700.0),
      sp.SpectralDistribution.from_normalized_black_body(4000.0),
      sp.SpectralDistribution.from_normalized_black_body(6500.0),
      sp.SpectralDistribution.from_normalized_black_body(12000.0),
      sp.SpectralDistribution.from_normalized_black_body(20000.0),
      spectral_data.d65(),
      sp.SpectralDistribution.constant(0.5),
      sp.SpectralDistribution.rgb_reflectance((0.5, 0.5, 0.5)),
      sp.SpectralDistribution.rgb_luminance((0.5, 0.5, 0.5)),
  ]
  bank, rgbs = [], []
  for s in spds:
    lum = max(s.luminance(), 1e-9)
    vals = np.asarray(s.values, np.float32) / lum
    bank.append(vals)
    rgbs.append(sp.SpectralDistribution(vals, s.cls).integrated_rgb())
  bank = torch.as_tensor(np.stack(bank), device=device)
  rgbs = torch.as_tensor(np.stack(rgbs).astype(np.float32), device=device)

  pix, x, y = _pixels(config, device)
  band = torch.clamp((9 * (h - 1 - y)) // h, 0, 8)
  state = rng.seed(pix, torch.zeros_like(pix))
  spectral_rgb = torch.zeros((w * h, 3), device=device)
  for i in range(_PLOT_SAMPLES):
    state, rnd = rng.next_float(state)
    wl = sp.sample_wavelength((i + rnd) / _PLOT_SAMPLES)
    spec_v = sp.query_bank(bank, band, wl)[..., 0]
    spectral_rgb = spectral_rgb + sp.xyz_to_rgb(
        sp.spectral_to_xyz(spec_v / sp.sampling_pdf(wl), wl))
  spectral_rgb = spectral_rgb / _PLOT_SAMPLES
  img = torch.where((x < w // 2)[..., None], spectral_rgb, rgbs[band])
  return img.reshape(h, w, 3)


def _render_thinfilm_curve(config, device):
  """Thin-film interference plot: x -> cos(theta) from 1 (left) to 0
  (right), y -> film thickness 0..2500 nm; 8 stratified wavelengths a
  pixel through `fresnel_thinfilm` (air outside, film eta 1.4, glass base
  eta 1.5), CIE -> RGB."""
  w, h = config.film_width, config.film_height
  pix, x, y = _pixels(config, device)
  cos_theta = 1.0 - (x.to(torch.float32) + 0.5) / w
  thickness = (y.to(torch.float32) + 0.5) / h * 2500.0
  state = rng.seed(pix, torch.zeros_like(pix))

  def ior(eta):
    return (torch.full_like(cos_theta, eta), torch.zeros_like(cos_theta))

  rgb = torch.zeros((w * h, 3), device=device)
  for i in range(_PLOT_SAMPLES):
    state, rnd = rng.next_float(state)
    wl = sp.sample_wavelength((i + rnd) / _PLOT_SAMPLES)
    f = bsdf_common.fresnel_thinfilm(wl, cos_theta, ior(1.0), ior(1.4), ior(1.5), thickness)
    rgb = rgb + sp.xyz_to_rgb(sp.spectral_to_xyz(f / sp.sampling_pdf(wl), wl))
  return (rgb / _PLOT_SAMPLES).reshape(h, w, 3)


def render_debug(scene, config, mode: int = DebugMode.Normals, device=None) -> torch.Tensor:
  """One AOV image (H, W, 3) on `device` (default: the CUDA card)."""
  device = resolve_device(device)
  w, h = config.film_width, config.film_height
  if mode == DebugMode.Spectrums:
    return _render_spectrums(config, device)
  if mode == DebugMode.ThinfilmCurve:
    return _render_thinfilm_curve(config, device)
  scene = st.to_device(scene, device)
  state = pt.make_lane_payload(scene, config, torch.arange(w * h, dtype=torch.int64,
                                                           device=device), w * h)
  if mode == DebugMode.Random:
    # the RNG stream, shown everywhere
    st2, r0 = rng.next_float(state.rng_state)
    st2, r1 = rng.next_float(st2)
    _, r2 = rng.next_float(st2)
    return torch.stack([r0, r1, r2], dim=-1).reshape(h, w, 3)
  hit = trace_ops.trace_closest(scene, state.ray_o, state.ray_d, state.t_min, state.t_max)
  pos, nrm, tan, btn, uv, bc, tri, trows = pt._interpolate_hit(scene, hit)
  mat = packed.MaterialRows(scene.mat_table[trows.mat])
  sd = lobes.ShadingData(w_i=state.ray_d, nrm=nrm, tan=tan, btn=btn, geo_n=trows.geo_n,
                         tex=uv, wl=state.wl, medium=state.medium, mat=mat)

  if mode == DebugMode.Barycentrics:
    img = bc
  elif mode == DebugMode.Normals:
    img = nrm * 0.5 + 0.5
  elif mode == DebugMode.Tangents:
    img = tan * 0.5 + 0.5
  elif mode == DebugMode.Bitangents:
    img = btn * 0.5 + 0.5
  elif mode == DebugMode.TexCoords:
    img = torch.cat([uv, torch.zeros_like(uv[..., :1])], dim=-1)
  elif mode == DebugMode.GeometricNormals:
    img = trows.geo_n * 0.5 + 0.5
  elif mode == DebugMode.FaceOrientation:
    cos_d = em.dot(trows.geo_n, state.ray_d)
    base = 0.5 + 0.5 * torch.abs(cos_d)
    img = torch.where((cos_d < 0.0)[..., None],
                      torch.stack([base * 0.2, base, base * 0.2], dim=-1),
                      torch.stack([base, base * 0.2, base * 0.2], dim=-1))
  elif mode == DebugMode.Depth:
    d = torch.where(hit.found, hit.t, 0.0)
    img = torch.stack([d, d, d], dim=-1) / torch.clamp(2.0 * scene.bsphere_radius, min=1e-6)
  elif mode == DebugMode.MaterialIndex:
    mi = trows.mat.to(torch.float32)
    img = torch.stack([torch.sin(mi * 2.1) * 0.5 + 0.5,
                       torch.sin(mi * 3.7 + 1.0) * 0.5 + 0.5,
                       torch.sin(mi * 5.3 + 2.0) * 0.5 + 0.5], dim=-1)
  elif mode == DebugMode.Albedo:
    img = spx.to_film_rgb(bsdf_dispatch.albedo(scene, sd, config.spectral), state.wl,
                          config.spectral)
  elif mode == DebugMode.Fresnel:
    f = lobes._fresnel_at(scene, sd, em.dot(state.ray_d, nrm), config.spectral)
    img = spx.to_film_rgb(f, state.wl, config.spectral)
  elif mode == DebugMode.EmitterIndex:
    e = (trows.emitter >= 0).to(torch.float32)
    img = torch.stack([e, e, torch.zeros_like(e)], dim=-1)
  elif mode == DebugMode.TransmittanceColor:
    img = spx.to_film_rgb(lobes._scattering(scene, sd, config.spectral), state.wl,
                          config.spectral)
  elif mode == DebugMode.ReflectanceColor:
    img = spx.to_film_rgb(lobes._reflectance(scene, sd, config.spectral), state.wl,
                          config.spectral)
  elif mode == DebugMode.IOR:
    # the eta ratio at the hit, grey over [1, 3]
    g = torch.clamp((lobes._eta_ratio(scene, sd, config.spectral) - 1.0) / 2.0, 0.0, 1.0)
    img = torch.stack([g, g, g], dim=-1)
  else:
    img = torch.zeros((w * h, 3), device=device)
  return torch.where(hit.found[..., None], img, 0.0).reshape(h, w, 3)
