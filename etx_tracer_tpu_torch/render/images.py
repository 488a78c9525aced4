"""The image bank: bilinear lookups and importance sampling of images.

Counterpart of `etx_tracer_tpu/render/images.py` for what the environment,
the sun disk and the lens aperture read: `evaluate` (bilinear, repeat
addressing), `sample` (an alias-table draw over the image's
luminance x sin(theta) distribution) and `pdf_at` (that distribution's
density), and the host-side `build_bank`. Every image lives in one padded
(I, H, W, 4) bank beside its true size; lookups are per-lane gathers.

The alias tables are built on the host by the native library's builder
(`native/alias_builder.cpp`) when it builds, else in Python by the same
algorithm, step for step (`alias_tables`): a Vose
table over each row rescaled by its own double sum, whose leftovers and
zero rows alias to themselves. Both packages then freeze the same tables,
bit for bit, and a draw lands on the same texel.

Materials read the bank through `apply_rgb_image` (a colour times the
texel's RGB), `apply_scalar_image` (a factor times one channel) and
`apply_normal_map` (a tangent-space normal map). Each is gated on a host
fact fixed when the scene is frozen, `scene.material_features` (the
material image columns that some material uses,
`scene/packed.material_features`): where no material has
the image, the call returns its input untouched and launches nothing, so a
scene with a sky but untextured materials pays nothing for texturing. The
results are those of the JAX package's calls, which run the lookups
whenever the bank holds an image and select them away.
"""

from __future__ import annotations

import numpy as np
import torch

from etx_tracer_tpu_torch import native
from etx_tracer_tpu_torch.core import math as em

# the largest uniform below 1 that a draw reads (float32 0.99999988)
_U_MAX = 1.0 - 1e-7


def evaluate(bank, idx: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
  """Bilinear RGBA lookup with repeat addressing: idx (R,), uv (R,2) ->
  (R,4), the four texels' bilinear-weighted sum."""
  size = bank.size[idx].to(torch.float32)
  w = size[:, 0]
  h = size[:, 1]
  x = uv[:, 0] * w - 0.5
  y = uv[:, 1] * h - 0.5
  x0 = torch.floor(x)
  y0 = torch.floor(y)
  dx = x - x0
  dy = y - y0

  def wrap(v, n):
    # a floored modulo (jnp.mod's), so texel -1 wraps to n - 1
    m = torch.remainder(v, n)
    return torch.where(m < 0, m + n, m).to(torch.int64)

  xi0 = wrap(x0, w)
  xi1 = wrap(x0 + 1, w)
  yi0 = wrap(y0, h)
  yi1 = wrap(y0 + 1, h)
  p00 = bank.pixels[idx, yi0, xi0]
  p01 = bank.pixels[idx, yi0, xi1]
  p10 = bank.pixels[idx, yi1, xi0]
  p11 = bank.pixels[idx, yi1, xi1]
  wx0 = (1.0 - dx)[..., None]
  wx1 = dx[..., None]
  wy0 = (1.0 - dy)[..., None]
  wy1 = dy[..., None]
  return (p00 * wx0 + p01 * wx1) * wy0 + (p10 * wx0 + p11 * wx1) * wy1


def bank_is_empty(bank) -> bool:
  """Whether the bank is the builder's 1x1 stand-in for "no images" (read
  from the shape, so no value leaves the card)."""
  return tuple(bank.pixels.shape[:3]) == (1, 1, 1)


def _alias_pick(gather_p, gather_i, u: torch.Tensor, n: int):
  """An O(1) alias draw over n slots. gather_p / gather_i map the slot
  tensor to its table entries. Returns (index, the uniform left within the
  chosen branch), all in float32 in the JAX package's order."""
  scaled = torch.clamp(u, 0.0, _U_MAX) * n
  j = scaled.to(torch.int64)
  frac = scaled - j.to(torch.float32)
  prob = gather_p(j)
  alias = gather_i(j)
  keep = frac < prob
  idx = torch.where(keep, j, alias.to(torch.int64))
  sub = torch.where(keep, frac / torch.clamp(prob, min=1e-12),
                    (frac - prob) / torch.clamp(1.0 - prob, min=1e-12))
  return idx, torch.clamp(sub, 0.0, _U_MAX)


def sample(bank, idx: torch.Tensor, rnd: torch.Tensor):
  """Importance-sample (uv (R,2), pdf (R,)) from each lane's image: the row
  by the marginal table, the column by that row's table, each over the
  padded extent (slots outside the image have probability 0)."""
  size = bank.size[idx]
  fw = size[:, 0].to(torch.float32)
  fh = size[:, 1].to(torch.float32)
  h_pad = bank.col_ap.shape[1]
  w_pad = bank.row_ap.shape[2]
  y, dy = _alias_pick(lambda j: bank.col_ap[idx, j], lambda j: bank.col_ai[idx, j],
                      rnd[:, 1], h_pad)
  x, dx = _alias_pick(lambda j: bank.row_ap[idx, y, j], lambda j: bank.row_ai[idx, y, j],
                      rnd[:, 0], w_pad)
  uv = torch.stack([(x.to(torch.float32) + dx) / fw, (y.to(torch.float32) + dy) / fh], dim=-1)
  return uv, pdf_at(bank, idx, uv)


def pdf_at(bank, idx: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
  """The sampling density at uv: luminance x sin(pi v) over the image's
  normalization (no sin factor for an image one row high)."""
  texel = evaluate(bank, idx, uv)
  lum = em.luminance(texel[:, :3])
  s_t = torch.clamp(torch.sin(em.kPi * torch.clamp(uv[:, 1], 0.0, 1.0)), min=0.0)
  s_t = torch.where(bank.size[idx, 1] <= 1, 1.0, s_t)
  return lum * s_t / torch.clamp(bank.normalization[idx], min=1e-12)


def apply_rgb_image(scene, response: torch.Tensor, mat, column: str, uv: torch.Tensor,
                    wl=None, spectral: bool = False) -> torch.Tensor:
  """response times the RGB of each lane's image `getattr(mat, column)` at
  uv, where the lane has one (in spectral mode the RGB is upsampled at the
  lane's wavelength); response itself where no material has such an
  image."""
  if column not in scene.material_features:
    return response
  from etx_tracer_tpu_torch.render import spectral as spx
  img_idx = getattr(mat, column)
  texel = evaluate(scene.images, torch.clamp(img_idx, min=0), uv)
  scaled = spx.apply_rgb(response, texel[:, :3], wl, spectral)
  return torch.where((img_idx >= 0)[..., None], scaled, response)


def scalar_image(scene, img_idx: torch.Tensor, uv: torch.Tensor, channel, default):
  """Channel `channel` ((R,) int or an int) of each lane's image `img_idx`
  at uv, `default` where a lane has no image (img_idx < 0) and everywhere
  when the bank is empty (the JAX package's single-channel lookup; the
  shading code takes `apply_scalar_image`, gated on host facts)."""
  if bank_is_empty(scene.images):
    return default if isinstance(default, torch.Tensor) else torch.full(
        img_idx.shape, float(default), device=img_idx.device)
  texel = evaluate(scene.images, torch.clamp(img_idx, min=0), uv)
  ch = torch.clamp(torch.as_tensor(channel, device=img_idx.device), 0, 3).to(torch.int64)
  v = torch.gather(texel, 1, ch.expand(img_idx.shape)[:, None])[:, 0]
  return torch.where(img_idx >= 0, v, default)


def apply_scalar_image(scene, value: torch.Tensor, mat, column: str, uv: torch.Tensor,
                       channel: int = 0) -> torch.Tensor:
  """value ((R,) or (R,k)) times channel `channel` of each lane's image
  `getattr(mat, column)` at uv (times 1 where the lane has none); value
  itself where no material has such an image."""
  if column not in scene.material_features:
    return value
  img_idx = getattr(mat, column)
  texel = evaluate(scene.images, torch.clamp(img_idx, min=0), uv)
  s = torch.where(img_idx >= 0, texel[:, channel], 1.0)
  return value * (s[..., None] if value.dim() > 1 else s)


def _unit(v: torch.Tensor) -> torch.Tensor:
  return v / torch.clamp(torch.sqrt(em.dot(v, v)), min=1e-9)[..., None]


def apply_normal_map(scene, sd, geo_n: torch.Tensor):
  """The shading data with each lane's tangent-space normal map applied
  (where the material has one and a normal scale above kEpsilon): the
  mapped normal, blended toward geo_n up to four times until it lies on
  the incident ray's geometric side, and the tangent frame rebuilt around
  it. `sd` itself where no material has a normal map."""
  if "normal_img" not in scene.material_features:
    return sd
  img = sd.mat.normal_img
  scale = sd.mat.normal_scale
  active = (img >= 0) & (scale > em.kEpsilon)
  texel = evaluate(scene.images, torch.clamp(img, min=0), sd.tex)
  n_ts = texel[:, :3] * 2.0 - 1.0
  n_ts = _unit(torch.cat([n_ts[:, :2] * scale[..., None], n_ts[:, 2:3]], dim=-1))
  nrm = _unit(sd.tan * n_ts[:, 0:1] + sd.btn * n_ts[:, 1:2] + sd.nrm * n_ts[:, 2:3])

  # orient the normal to the hemisphere of the incident ray's geometric side
  i_dot_g = em.dot(sd.w_i, geo_n)
  n_fixed = nrm
  for _ in range(4):
    bad = (em.dot(sd.w_i, n_fixed) * i_dot_g) <= em.kEpsilon
    n_fixed = torch.where(bad[..., None], _unit(n_fixed * 8.0 + geo_n), n_fixed)

  tan = _unit(sd.tan - n_fixed * em.dot(sd.tan, n_fixed)[..., None])
  btn = em.cross(n_fixed, tan)
  m = active[..., None]
  return sd._replace(nrm=torch.where(m, n_fixed, sd.nrm), tan=torch.where(m, tan, sd.tan),
                     btn=torch.where(m, btn, sd.btn))


# ---------------------------------------------------------------------------
# Host-side bank building
# ---------------------------------------------------------------------------


def alias_tables(p: np.ndarray):
  """Vose alias tables of each row of p ((rows, n) float32, zeros allowed):
  (prob (rows, n) float32, alias (rows, n) int32). Keep slot j when a
  draw's fraction is below prob[j], else take alias[j].

  The JAX package's native builder's algorithm, step for step: a row is
  rescaled by n over its sequential double sum, small and large slots go
  on two stacks in index order and pop from their tops, and the slots left
  on either stack, like every slot of a row that sums to 0, keep
  themselves with probability 1. Python floats are doubles, so each step
  rounds as the native code does."""
  p = np.ascontiguousarray(p, np.float32)
  rows, n = p.shape
  prob = np.ones((rows, n), np.float32)
  alias = np.tile(np.arange(n, dtype=np.int32), (rows, 1))
  for r in range(rows):
    pr = p[r].astype(np.float64).tolist()
    total = 0.0
    for v in pr:
      total += v
    if total <= 0.0:
      continue
    k = n / total
    scaled = [v * k for v in pr]
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    out_p = prob[r]
    out_a = alias[r]
    while small and large:
      s = small.pop()
      l = large.pop()
      out_p[s] = scaled[s]
      out_a[s] = l
      scaled[l] = (scaled[l] + scaled[s]) - 1.0
      (small if scaled[l] < 1.0 else large).append(l)
  return prob, alias


def empty_bank() -> dict:
  """The bank of a scene without images: one 1x1 white texel, keyed by
  ImageBank field."""
  return {
      "pixels": np.ones((1, 1, 1, 4), np.float32),
      "size": np.ones((1, 2), np.int32),
      "offset": np.zeros((1, 2), np.float32),
      "scale_u": np.ones(1, np.float32),
      "normalization": np.ones(1, np.float32),
      "col_ap": np.ones((1, 1), np.float32),
      "col_ai": np.zeros((1, 1), np.int32),
      "row_ap": np.ones((1, 1, 1), np.float32),
      "row_ai": np.zeros((1, 1, 1), np.int32),
  }


def build_bank(images: list) -> dict:
  """The image bank, as numpy arrays keyed by ImageBank field, from a list
  of {"pixels" (H,W,4) float32, "offset" (2,), "u_scale", "build_cdf",
  "uniform"}: every image padded to the largest height and width; an
  image with `build_cdf` gets its luminance x sin(theta) distribution (a
  uniform row weight with `uniform` or one row) as alias tables over the
  padded extents and its pdf normalization. The JAX package's build, in
  the same numpy operations."""
  if not images:
    return empty_bank()
  h_max = max(im["pixels"].shape[0] for im in images)
  w_max = max(im["pixels"].shape[1] for im in images)
  n = len(images)
  pixels = np.zeros((n, h_max, w_max, 4), np.float32)
  size = np.zeros((n, 2), np.int32)
  offset = np.zeros((n, 2), np.float32)
  scale_u = np.ones(n, np.float32)
  normalization = np.ones(n, np.float32)
  col_ap = np.ones((n, h_max), np.float32)
  col_ai = np.zeros((n, h_max), np.int32)
  row_ap = np.ones((n, h_max, w_max), np.float32)
  row_ai = np.zeros((n, h_max, w_max), np.int32)

  col_batch, row_batch, cdf_ids = [], [], []
  for i, im in enumerate(images):
    px = im["pixels"].astype(np.float32)
    h, w = px.shape[:2]
    pixels[i, :h, :w] = px
    size[i] = (w, h)
    offset[i] = im.get("offset", (0.0, 0.0))
    scale_u[i] = im.get("u_scale", 1.0)
    if im.get("build_cdf", False):
      lum = (px[..., 0] * 0.212671 + px[..., 1] * 0.715160 + px[..., 2] * 0.072169)
      v = (np.arange(h) + 0.5) / h
      row_w = np.ones(h) if im.get("uniform", False) or h == 1 else np.sin(v * np.pi)
      row_sums = lum.sum(axis=1)
      # a zero row samples uniformly over the true width (its marginal
      # weight is 0, so no draw lands there)
      safe = np.where(row_sums > 0, row_sums, 1.0)[:, None]
      rp = np.where((row_sums > 0)[:, None], lum / safe, 1.0 / w)
      weighted = row_sums * row_w
      total = weighted.sum()
      cp = weighted / (total if total > 0 else 1.0)
      normalization[i] = total / (w * h)
      cp_pad = np.zeros(h_max, np.float64)
      cp_pad[:h] = cp
      rp_pad = np.zeros((h_max, w_max), np.float64)
      rp_pad[:h, :w] = rp
      cdf_ids.append(i)
      col_batch.append(cp_pad)
      row_batch.append(rp_pad)

  if cdf_ids:
    cols = np.asarray(col_batch, np.float32)
    rows = np.concatenate(row_batch, axis=0).astype(np.float32)
    # the native builder when its library builds (milliseconds, where the
    # Python loop takes seconds on a large map); the same tables
    built_c = native.build_alias_tables(cols)
    built_r = native.build_alias_tables(rows)
    if built_c is None or built_r is None:
      built_c, built_r = alias_tables(cols), alias_tables(rows)
    for k, i in enumerate(cdf_ids):
      col_ap[i], col_ai[i] = built_c[0][k], built_c[1][k]
      row_ap[i] = built_r[0][k * h_max:(k + 1) * h_max]
      row_ai[i] = built_r[1][k * h_max:(k + 1) * h_max]

  return {"pixels": pixels, "size": size, "offset": offset, "scale_u": scale_u,
          "normalization": normalization, "col_ap": col_ap, "col_ai": col_ai,
          "row_ap": row_ap, "row_ai": row_ai}
