"""Woop unit-triangle ray/triangle intersection, for any triangle count.

Two functions, each a CUDA kernel (`csrc/woop_trace.cu`) with a plain
PyTorch version of the same signature beside it:

- `intersect` (K9a): closest hit, the port of the TPU kernel
  `etx_tracer_tpu/ops/pallas_trace.py:intersect_woop_pallas`;
- `occluded` (K9b): any hit, the port of `pallas_trace.occluded_woop_pallas`.

They compute what `pallas_trace._kernel_woop` computes, which is neither K1
nor K3: each triangle becomes the affine map A = [e1 e2 n]^-1, b = -A v0
(`woop_tables`, 12 floats a triangle, the z row scaled to the unit normal),
a ray becomes w = A o + b and q = A d, and then t = -w_z / q_z,
u = w_x + t q_x, v = w_y + t q_y. A pair is valid when |q_z| > 1e-7,
u >= 0, v >= 0, u + v <= 1 and t_min <= t <= t_max. Masked and degenerate
triangles (|e1 x e2|^2 <= 1e-18) get all-zero rows, so q_z = 0 rejects them
and no pair is tested against the mask.

The TPU kernel hands w and q to its matrix unit as one (256, 8) x
(8, 6 * 512) product per chunk; here both the kernel and the plain version
write the six dot products out as sums in one fixed order (no
`torch.matmul`: cuBLAS picks its own order, and TF32 would bring back the
false hits the TPU kernel's HIGHEST precision guards against). The closest
hit is the least t, the lowest triangle index among equal ones, as the TPU
kernel's lowest lane per chunk and strict `<` across chunks give.

Neither the trace dispatch nor the renderer calls these kernels: the
micro-benchmark (`benchmarks/micro.py trace_brute`) runs them against K3/K4,
as the JAX package's does.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
builds the table (once per call, as the JAX wrapper does) and launches the
kernel or raises. `launches` counts kernel launches (never plain calls).

The kernels skip a ray whose interval is empty (`dead_lanes`: !(t_min <=
t_max), NaN ends included) and write its miss at once, and K9a sends a pair
of a ray with t_min > 0 to its division only when the sign bits of w_z and
q_z differ (`sign_candidates`) and its t cannot exceed the ray's t_max or
best t so far (a test by one fused multiply-add); the proofs are in
`csrc/woop_trace.cu`. The plain versions test every pair of every ray; the
CPU tests (`tests/test_torch_woop_lanes.py`) hold that no such test drops a
pair that could win.
"""

from __future__ import annotations

import ctypes

import torch

from etx_tracer_tpu_torch.ops import _build, brute_trace
from etx_tracer_tpu_torch.ops.brute2_trace import _ray_tiles
from etx_tracer_tpu_torch.ops.brute_trace import Hit

CHUNK = 512                 # triangles per chunk, as the TPU kernel's _W_TC
ROW = 12                    # r_u, b_u, r_v, b_v, r_w, b_w
TILE_RAYS = 256             # rays per block of the kernels (one block a tile)
MAX_ROWS = 1024             # table rows the kernels stage in shared memory at once
_QZ_EPS = 1e-7              # |cos(direction, plane normal)| cutoff
_DEGENERATE = 1e-18         # |e1 x e2|^2 at or below: no triangle

launches = {"intersect": 0, "occluded": 0}


def woop_tables(tri_v0, tri_e1, tri_e2, tri_mask=None) -> torch.Tensor:
  """(T, 12) float32 rows [r_u, b_u, r_v, b_v, r_w, b_w], as
  `pallas_trace._woop_tables` computes them (without its chunked matmul
  layout): r_u = (e2 x n) / |n|^2, r_v = (n x e1) / |n|^2, r_w = n / |n|,
  b_k = -(r_k . v0), n = e1 x e2. Masked or degenerate triangles get all-zero
  rows."""
  def cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)

  def dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

  n = cross(tri_e1, tri_e2)
  det = dot(n, n)[:, None]                               # |n|^2
  good = det > _DEGENERATE
  if tri_mask is not None:
    good = good & tri_mask[:, None]
  safe = torch.where(good, det, 1.0)
  r_u = cross(tri_e2, n) * (1.0 / safe)
  r_v = cross(n, tri_e1) * (1.0 / safe)
  r_w = n * torch.rsqrt(safe)
  rows = torch.cat([r_u, -dot(r_u, tri_v0)[:, None], r_v, -dot(r_v, tri_v0)[:, None],
                    r_w, -dot(r_w, tri_v0)[:, None]], dim=1)
  return torch.where(good, rows, 0.0).contiguous()


# --------------------------------------------------------------- plain versions


def dead_lanes(t_min, t_max):
  """The kernels' skip test, (R,) bool: !(t_min <= t_max), compared in
  float32 as the kernels compare them. A valid pair needs t_min <= t <= t_max
  on one t, so such a ray (NaN ends included) has none."""
  return ~(t_min <= t_max)


def sign_candidates(tab, ray):
  """K9a's sign test, (R, C) bool for (R, 1) ray columns against (C, 12)
  rows: |q_z| > 1e-7 and, where t_min > 0, the sign bits of w_z and q_z
  unequal (read from the bits, as the kernel reads them); q_z and w_z as
  `_pairs` forms them. A pair it rejects is never valid by `_pairs` (nor is
  one with w_z = 0 and t_min > 0, which it keeps); only the tests call it."""
  ox, oy, oz, dx, dy, dz, tmin, _ = ray
  nx, ny, nz, nb = tab[:, 8], tab[:, 9], tab[:, 10], tab[:, 11]
  wz = nx * ox + ny * oy + nz * oz + nb
  qz = nx * dx + ny * dy + nz * dz
  signs_differ = (wz.contiguous().view(torch.int32) ^ qz.contiguous().view(torch.int32)) < 0
  return (torch.abs(qz) > _QZ_EPS) & (~(tmin > 0.0) | signs_differ)


def _pairs(tab, ray):
  """The kernel's arithmetic for (R, 1) ray columns against (C, 12) table
  rows: (ok, t, u, v), each (R, C)."""
  ox, oy, oz, dx, dy, dz, tmin, tmax = ray
  ux, uy, uz, ub, vx, vy, vz, vb, nx, ny, nz, nb = tab.unbind(1)
  wx = ux * ox + uy * oy + uz * oz + ub
  wy = vx * ox + vy * oy + vz * oz + vb
  wz = nx * ox + ny * oy + nz * oz + nb
  qx = ux * dx + uy * dy + uz * dz
  qy = vx * dx + vy * dy + vz * dz
  qz = nx * dx + ny * dy + nz * dz
  live = torch.abs(qz) > _QZ_EPS
  t = -wz / torch.where(live, qz, 1.0)
  u = wx + t * qx
  v = wy + t * qy
  ok = live & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= tmin) & (t <= tmax)
  return ok, t, u, v


def closest_from_table(tab, o, d, t_min, t_max) -> Hit:
  """Closest hit against a Woop table: per 512-row chunk the lowest lane
  with the least t wins; a later chunk replaces the best only when strictly
  nearer."""
  num_r, num_t = o.shape[0], tab.shape[0]
  dev = o.device
  t_out = torch.full((num_r,), float("inf"), dtype=torch.float32, device=dev)
  tri_out = torch.full((num_r,), -1, dtype=torch.int32, device=dev)
  u_out = torch.zeros(num_r, dtype=torch.float32, device=dev)
  v_out = torch.zeros(num_r, dtype=torch.float32, device=dev)
  for sl, ray in _ray_tiles(o, d, t_min, t_max):
    best_t, best_tri = t_out[sl], tri_out[sl]
    best_u, best_v = u_out[sl], v_out[sl]
    for s in range(0, num_t, CHUNK):
      ok, t, u, v = _pairs(tab[s:s + CHUNK], ray)
      tm = torch.where(ok, t, float("inf"))
      t_c = tm.min(dim=1, keepdim=True).values
      lane = torch.arange(tm.shape[1], dtype=torch.int32, device=dev)
      idx = torch.where(tm == t_c, lane, CHUNK).min(dim=1, keepdim=True).values
      idx_l = torch.clamp(idx, max=tm.shape[1] - 1).to(torch.int64)
      t_w, u_w, v_w = (x.gather(1, idx_l)[:, 0] for x in (tm, u, v))
      better = t_w < best_t
      best_t = torch.where(better, t_w, best_t)
      best_tri = torch.where(better, s + idx[:, 0], best_tri)
      best_u = torch.where(better, u_w, best_u)
      best_v = torch.where(better, v_w, best_v)
    t_out[sl], tri_out[sl], u_out[sl], v_out[sl] = best_t, best_tri, best_u, best_v
  return Hit(t_out, tri_out, u_out, v_out)


def occluded_from_table(tab, o, d, t_min, t_max) -> torch.Tensor:
  """Any valid pair against a Woop table, OR over every chunk."""
  occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
  for sl, ray in _ray_tiles(o, d, t_min, t_max):
    hit = occ[sl]
    for s in range(0, tab.shape[0], CHUNK):
      hit = hit | _pairs(tab[s:s + CHUNK], ray)[0].any(dim=1)
    occ[sl] = hit
  return occ


def intersect_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> Hit:
  """Closest hit, as `_kernel_woop`, on the table `woop_tables` builds."""
  return closest_from_table(woop_tables(tri_v0, tri_e1, tri_e2, tri_mask), o, d, t_min, t_max)


def occluded_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> torch.Tensor:
  """Any hit, as `_kernel_woop_anyhit`, on the table `woop_tables` builds."""
  return occluded_from_table(woop_tables(tri_v0, tri_e1, tri_e2, tri_mask), o, d, t_min, t_max)


# ------------------------------------------------------------------ the kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_COMMON = [_P, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I]
_lib = None


def bind(lib):
  """Sets the argument and result types of a built `csrc/woop_trace.cu`
  library's entries and returns it; an earlier source's library, which may
  lack `etx_woop_occupancy`, binds too."""
  lib.etx_woop_intersect.argtypes = _COMMON + [_P, _P, _P, _P, _P]
  lib.etx_woop_intersect.restype = _I
  lib.etx_woop_occluded.argtypes = _COMMON + [_P, _P]
  lib.etx_woop_occluded.restype = _I
  if hasattr(lib, "etx_woop_occupancy"):
    lib.etx_woop_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.etx_woop_occupancy.restype = _I
  lib.etx_woop_error_string.argtypes = [_I]
  lib.etx_woop_error_string.restype = ctypes.c_char_p
  return lib


def _library():
  global _lib
  if _lib is None:
    _lib = bind(_build.load("woop_trace"))
  return _lib


def _raise_on(lib, rc: int, what: str):
  if rc != 0:
    msg = lib.etx_woop_error_string(rc).decode()
    raise RuntimeError(f"woop_trace {what} kernel launch failed: {msg} (cudaError {rc})")


def occupancy(num_t: int, any_hit: bool) -> int:
  """Blocks of K9a (any_hit False) or K9b that one SM holds at once for a
  table of num_t triangles (registers and shared memory decide), by the CUDA
  runtime's occupancy calculator on the current device."""
  lib, blocks = _library(), _I(0)
  _raise_on(lib, lib.etx_woop_occupancy(num_t, int(any_hit), ctypes.byref(blocks)), "occupancy")
  return blocks.value


def launch_with(lib, entry, tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None):
  """K9a (entry "intersect": a Hit) or K9b ("occluded": (R,) bool) of a
  bound library (`bind`) on CUDA tensors, on the current stream, the table
  built for the call; counts no launch. `intersect` and `occluded` call it
  with this source's library."""
  num_t, num_r = brute_trace._check(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask,
                                    what="Woop")
  tab = woop_tables(tri_v0, tri_e1, tri_e2, tri_mask)  # outlives the launch
  if tab.data_ptr() % 16:
    raise ValueError("the Woop table must be 16-byte aligned")
  dev = o.device
  if entry == "intersect":
    outs = [torch.empty(num_r, dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
  else:
    outs = [torch.empty(num_r, dtype=torch.bool, device=dev)]
  if num_r > 0:
    with torch.cuda.device(dev):
      stream = torch.cuda.current_stream(dev).cuda_stream
      fn = lib.etx_woop_intersect if entry == "intersect" else lib.etx_woop_occluded
      rc = fn(tab.data_ptr(), num_t, o.data_ptr(), o.stride(0), o.stride(1),
              d.data_ptr(), d.stride(0), d.stride(1), t_min.data_ptr(), t_max.data_ptr(),
              num_r, *(x.data_ptr() for x in outs), stream)
    _raise_on(lib, rc, entry)
  return Hit(*outs) if entry == "intersect" else outs[0]


def intersect(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> Hit:
  """Closest hit of each ray: Hit(t, tri, u, v). K9a on CUDA tensors, the
  plain version on CPU tensors."""
  if o.device.type == "cpu":
    return intersect_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask)
  hit = launch_with(_library(), "intersect", tri_v0, tri_e1, tri_e2, o, d, t_min, t_max,
                    tri_mask)
  if o.shape[0] > 0:
    launches["intersect"] += 1
  return hit


def occluded(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> torch.Tensor:
  """Any-hit occlusion of each ray: (R,) bool. K9b on CUDA tensors, the plain
  version on CPU tensors."""
  if o.device.type == "cpu":
    return occluded_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask)
  occ = launch_with(_library(), "occluded", tri_v0, tri_e1, tri_e2, o, d, t_min, t_max,
                    tri_mask)
  if o.shape[0] > 0:
    launches["occluded"] += 1
  return occ
