"""Vectorized geometric math over batched torch tensors.

Counterpart of `etx_tracer_tpu/core/math.py`: every function works on
tensors with a trailing component axis (``[..., 3]`` vectors), so one call
processes a whole wavefront. Sums over the three components are written out
term by term, in the order ((x + y) + z), so the CPU and the card add in the
same order.
"""

from __future__ import annotations

import functools

import torch

kPi = 3.14159265358979323846
kDoublePi = 6.28318530717958647692
kQuarterPi = 0.78539816339744830961
kHalfPi = 1.57079632679489661923
kInvPi = 0.31830988618379067153
kEpsilon = 1.192092896e-07
kMaxFloat = 3.402823466e+38
kMaxHalf = 65504.0
kInvMaxHalf = 1.0 / kMaxHalf
kRayEpsilon = 15.0 / (kMaxHalf - 1.0)
kDeltaAlphaThreshold = 1.0e-4


@functools.lru_cache(maxsize=None)
def constant(values: tuple, device: torch.device) -> torch.Tensor:
  """A small float32 constant on `device`, copied there once per process
  (a copy from the host per call would wait for the card)."""
  return torch.tensor(values, dtype=torch.float32, device=device)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Dot product over the trailing axis, keeps the batch shape."""
  return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v: torch.Tensor) -> torch.Tensor:
  return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: torch.Tensor) -> torch.Tensor:
  """v / |v|, scaled by 1 / sqrt: a square root and a reciprocal, each
  correctly rounded on the CPU and on the card, so both give the same bits
  (rsqrt is approximate on the card, and in the CPU's vector loop it
  rounds apart from 1 / sqrt on about 0.6% of inputs). One kernel more
  than rsqrt."""
  return v * torch.sqrt(torch.clamp(dot(v, v), min=1e-30)).reciprocal_()[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
  bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
  return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
  return v - (2.0 * dot(v, n))[..., None] * n


def luminance(rgb: torch.Tensor) -> torch.Tensor:
  """Rec. 709 luminance."""
  return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169


def lerp(a, b, t):
  return a * (1.0 - t) + b * t


def sqr(x):
  return x * x


def saturate(x: torch.Tensor) -> torch.Tensor:
  return torch.clamp(x, 0.0, 1.0)


def orthonormalize(nrm: torch.Tensor, tan: torch.Tensor) -> torch.Tensor:
  """tan with its component along nrm removed, normalised."""
  return normalize(tan - dot(tan, nrm)[..., None] * nrm)


def make_frame(tan, btn, nrm):
  """A local frame. The JAX package stacks it into a (..., 3, 3) matrix;
  here a frame is the (tan, btn, nrm) tuple that `to_local(*frame, v)` and
  `from_local(*frame, v)` take."""
  return (tan, btn, nrm)


def orthonormal_basis(n: torch.Tensor):
  """Branch-free orthonormal basis (u, v) around n."""
  nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
  distinct = (nx != ny) | (nx != nz)
  a = torch.where(
      distinct[..., None],
      torch.stack([nz - ny, nx - nz, ny - nx], dim=-1),
      torch.stack([nz - ny, nx + nz, -ny - nx], dim=-1),
  )
  u = normalize(a)
  v = normalize(cross(n, u))
  return u, v


def to_local(tan, btn, nrm, v):
  """World -> local in the frame with rows (tan, btn, nrm)."""
  return torch.stack([dot(tan, v), dot(btn, v), dot(nrm, v)], dim=-1)


def from_local(tan, btn, nrm, v):
  """Local -> world: v.x*tan + v.y*btn + v.z*nrm."""
  return v[..., 0:1] * tan + v[..., 1:2] * btn + v[..., 2:3] * nrm


def sample_cosine_distribution(rnd: torch.Tensor, exponent: float) -> torch.Tensor:
  """Power-cosine hemisphere sample in the local (+z) frame."""
  cos_theta = torch.pow(torch.clamp(rnd[..., 0], min=kEpsilon), 1.0 / (exponent + 1.0))
  sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
  phi = rnd[..., 1] * kDoublePi
  return torch.stack([torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta], dim=-1)


def sample_cosine_distribution_n(rnd: torch.Tensor, n: torch.Tensor, exponent: float) -> torch.Tensor:
  """Power-cosine sample around the world direction n."""
  u, v = orthonormal_basis(n)
  l = sample_cosine_distribution(rnd, exponent)
  return u * l[..., 0:1] + v * l[..., 1:2] + n * l[..., 2:3]


def sample_disk(rnd: torch.Tensor) -> torch.Tensor:
  """Concentric disk sample, branch-free."""
  ox = 2.0 * rnd[..., 0] - 1.0
  oy = 2.0 * rnd[..., 1] - 1.0
  x_major = torch.abs(ox) > torch.abs(oy)
  r = torch.where(x_major, ox, oy)
  safe_ox = torch.where(ox == 0.0, 1.0, ox)
  safe_oy = torch.where(oy == 0.0, 1.0, oy)
  theta = torch.where(x_major, kQuarterPi * (oy / safe_ox), kHalfPi - kQuarterPi * (ox / safe_oy))
  zero = (ox == 0.0) & (oy == 0.0)
  out = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
  return torch.where(zero[..., None], 0.0, out)


def barycentrics(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """(u, v) -> (1 - u - v, u, v)."""
  return torch.stack([1.0 - u - v, u, v], dim=-1)


def random_barycentric(rnd: torch.Tensor) -> torch.Tensor:
  r1 = torch.sqrt(rnd[..., 0])
  return torch.stack([1.0 - r1, r1 * (1.0 - rnd[..., 1]), r1 * rnd[..., 1]], dim=-1)


def offset_ray(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
  """Self-intersection-safe origin offset (Wächter-Binder).

  Moves p along n by a number of float ulps: the float bits are reinterpreted
  as int32 (`view`, a bitcast, never `.to`), shifted, and reinterpreted back.
  Near the origin, where ulps are tiny, a fixed float offset is used instead.
  """
  int_scale = 256.0
  float_scale = 1.0 / 65536.0
  origin = 1.0 / 32.0

  of_i = (int_scale * n).to(torch.int32)
  p_i = p.contiguous().view(torch.int32)
  shifted = torch.where(p > 0.0, p_i + of_i, p_i - of_i)
  p_adj = shifted.view(torch.float32)
  return torch.where(torch.abs(p) < origin, p + float_scale * n, p_adj)


def power_heuristic(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  f2 = f * f
  g2 = g * g
  denom = f2 + g2
  return torch.where(denom > 0.0, saturate(f2 / torch.clamp(denom, min=1e-37)),
                     torch.zeros_like(denom))


def to_spherical(d: torch.Tensor):
  """(phi, theta, r) of direction vectors: phi = atan2(z, x), theta the
  elevation asin(y / r)."""
  r = length(d)
  phi = torch.atan2(d[..., 2], d[..., 0])
  theta = torch.asin(torch.clamp(d[..., 1] / torch.clamp(r, min=1e-30), -1.0, 1.0))
  return phi, theta, r


def from_spherical(phi: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
  cos_t = torch.cos(theta)
  return torch.stack([torch.cos(phi) * cos_t, torch.sin(theta), torch.sin(phi) * cos_t], dim=-1)


def _mirror_u(u: torch.Tensor, u_scale) -> torch.Tensor:
  """1 - u where the map's u scale is negative (a tensor of lanes or a
  number)."""
  if isinstance(u_scale, torch.Tensor):
    return torch.where(u_scale < 0.0, 1.0 - u, u)
  return 1.0 - u if u_scale < 0.0 else u


def uv_to_direction(uv: torch.Tensor, offset_u=0.0, u_scale=1.0) -> torch.Tensor:
  """Equirectangular uv -> direction; `offset_u` shifts and a negative
  `u_scale` mirrors the map in u."""
  u = _mirror_u(uv[..., 0], u_scale)
  u = u - offset_u
  u = u - torch.floor(u)
  phi = (u * 2.0 - 1.0) * kPi
  theta = (0.5 - uv[..., 1]) * kPi
  return from_spherical(phi, theta)


def direction_to_uv(d: torch.Tensor, offset_u=0.0, u_scale=1.0) -> torch.Tensor:
  """Direction -> equirectangular uv, the inverse of `uv_to_direction`."""
  phi, theta, _ = to_spherical(d)
  u = _mirror_u((phi / kPi + 1.0) / 2.0, u_scale)
  u = u + offset_u
  u = u - torch.floor(u)
  v = 0.5 - theta / kPi
  return torch.stack([u, v], dim=-1)


def distance_to_sphere(o: torch.Tensor, d: torch.Tensor, center: torch.Tensor,
                       radius) -> torch.Tensor:
  """Positive distance along each ray to the sphere, 0 on a miss."""
  e = o - center
  b = dot(d, e)
  disc = b * b - dot(e, e) + radius * radius
  s = torch.sqrt(torch.clamp(disc, min=0.0))
  a0 = -b - s
  a1 = -b + s
  t = torch.where(a0 < 0.0, torch.where(a1 < 0.0, 0.0, a1), a0)
  return torch.where(disc < 0.0, 0.0, t)


def gamma_to_linear(v: torch.Tensor) -> torch.Tensor:
  """The sRGB transfer function's inverse."""
  return torch.where(v <= 0.04045, v / 12.92,
                     torch.pow((torch.clamp(v, min=0.04045) + 0.055) / 1.055, 2.4))


def linear_to_gamma(v: torch.Tensor) -> torch.Tensor:
  """The sRGB transfer function."""
  return torch.where(v <= 0.0031308, 12.92 * v,
                     1.055 * torch.pow(torch.clamp(v, min=0.0031308), 1.0 / 2.4) - 0.055)
