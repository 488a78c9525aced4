"""Pair-tile ray/triangle intersection, for any triangle count.

Two functions, each a CUDA kernel (`csrc/brute2_trace.cu`) with a plain
PyTorch version of the same signature beside it:

- `intersect` (K3): closest hit, the port of the TPU kernel
  `etx_tracer_tpu/ops/pallas_trace.py:intersect_brute2_pallas`;
- `occluded` (K4): any hit, the port of `pallas_trace.occluded_brute2_pallas`.

They compute what `pallas_trace._kernel_brute2` computes, which is not what
K1 computes: validity is tested without a division on the sign-multiplied
forms a = u*|det|, b = v*|det|, tt = t*|det|; the mask is folded into the
geometry (a masked triangle gets zero edges); t = tt / |det|, and u, v are
divided by |det| through one reciprocal, for the winner only.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. The plain versions evaluate the TPU kernel's
expressions in its order over tiles of rays x 512-triangle chunks (a tile
holds at most 2^22 pairs, so no temporary grows past 16 MB); the CPU tests
hold them against the TPU kernel's own body run in interpret mode, and
`chip_smoke.py` holds each kernel against them on the card.

The kernels skip a ray whose interval admits no valid pair under their
rounding (`dead_lanes`: t_max <= 0 < 1e-30 < t_min, the main path's dead
lanes and pending-free shadow lanes) and write its miss at once; the plain
versions test it and find no valid pair, so the outputs are the same.

The trace dispatch (`ops/trace.py`) sends scenes of 129 to 4096 triangles
here, as the JAX package does; the kernels, like the TPU kernels, take any
count (the micro-benchmark runs K3/K4 on bigscene's 15,396 triangles).

`launches` counts kernel launches (never plain calls), so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from etx_tracer_tpu_torch.ops import _build, brute_trace
from etx_tracer_tpu_torch.ops.brute_trace import Hit

CHUNK = 512                 # triangles per chunk, as the TPU kernel's _B2_TC
TILE_RAYS = 256             # rays per block of the kernels (one block a tile)
_TILE_PAIRS = 1 << 22       # ray-triangle pairs per plain-version tile
_MT_EPS = 1e-9
# a ray with t_max <= 0 and t_min above this has no valid pair (the proof is
# in csrc/brute2_trace.cu); the kernels skip it
SKIP_T_MIN = 1e-30

launches = {"intersect": 0, "occluded": 0}


# --------------------------------------------------------------- plain versions


def dead_lanes(t_min, t_max):
  """The kernels' skip test, (R,) bool: t_max <= 0 and t_min > 1e-30 (both
  compared in float32, as the kernels compare them)."""
  return (t_max <= 0.0) & (t_min > SKIP_T_MIN)


def _folded(tri_e1, tri_e2, tri_mask):
  """Edges with the mask folded in: a masked triangle's edges become zero."""
  if tri_mask is None:
    return tri_e1, tri_e2
  m = tri_mask.to(torch.float32)[:, None]
  return tri_e1 * m, tri_e2 * m


def _pairs(v0, e1, e2, ray):
  """The TPU kernel's chunk arithmetic for (R, 1) ray columns against (C, 3)
  triangles: (ok, a, b, tt, dd), each (R, C)."""
  ox, oy, oz, dx, dy, dz, tmin, tmax = ray
  v0x, v0y, v0z = v0[:, 0], v0[:, 1], v0[:, 2]
  e1x, e1y, e1z = e1[:, 0], e1[:, 1], e1[:, 2]
  e2x, e2y, e2z = e2[:, 0], e2[:, 1], e2[:, 2]
  px = dy * e2z - dz * e2y
  py = dz * e2x - dx * e2z
  pz = dx * e2y - dy * e2x
  det = px * e1x + py * e1y + pz * e1z
  sgn = torch.where(det >= 0.0, 1.0, -1.0)
  dd = det * sgn
  tx = ox - v0x
  ty = oy - v0y
  tz = oz - v0z
  a = (tx * px + ty * py + tz * pz) * sgn
  qx = ty * e1z - tz * e1y
  qy = tz * e1x - tx * e1z
  qz = tx * e1y - ty * e1x
  b = (dx * qx + dy * qy + dz * qz) * sgn
  tt = (e2x * qx + e2y * qy + e2z * qz) * sgn
  ok = ((dd > _MT_EPS) & (a >= 0.0) & (b >= 0.0) & (a + b <= dd)
        & (tt >= tmin * dd) & (tt <= tmax * dd))
  return ok, a, b, tt, dd


def _ray_tiles(o, d, t_min, t_max):
  """(slice, ray columns) per tile of rays."""
  step = max(1, _TILE_PAIRS // CHUNK)
  for r0 in range(0, o.shape[0], step):
    sl = slice(r0, r0 + step)
    cols = tuple(x[sl, k:k + 1] for x in (o, d) for k in range(3))
    yield sl, cols + (t_min[sl, None], t_max[sl, None])


def intersect_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> Hit:
  """Closest hit, as `_kernel_brute2`: per 512-triangle chunk the lowest lane
  with the least t wins; a later chunk replaces the best only when strictly
  nearer; u and v divide by the winner's |det| once."""
  num_r, num_t = o.shape[0], tri_v0.shape[0]
  e1, e2 = _folded(tri_e1, tri_e2, tri_mask)
  dev = o.device
  t_out = torch.full((num_r,), float("inf"), dtype=torch.float32, device=dev)
  tri_out = torch.full((num_r,), -1, dtype=torch.int32, device=dev)
  u_out = torch.zeros(num_r, dtype=torch.float32, device=dev)
  v_out = torch.zeros(num_r, dtype=torch.float32, device=dev)
  for sl, ray in _ray_tiles(o, d, t_min, t_max):
    best_t, best_tri = t_out[sl], tri_out[sl]
    best_u, best_v = u_out[sl], v_out[sl]
    for s in range(0, num_t, CHUNK):
      c = slice(s, s + CHUNK)
      ok, a, b, tt, dd = _pairs(tri_v0[c], e1[c], e2[c], ray)
      tm = torch.where(ok, tt / torch.where(dd == 0.0, 1.0, dd), float("inf"))
      t_c = tm.min(dim=1, keepdim=True).values
      lane = torch.arange(tm.shape[1], dtype=torch.int32, device=dev)
      idx_c = torch.where(tm == t_c, lane, CHUNK).min(dim=1, keepdim=True).values
      idx_l = idx_c.to(torch.int64)
      a_c, b_c, dd_c = (x.gather(1, idx_l)[:, 0] for x in (a, b, dd))
      inv = 1.0 / torch.where(dd_c == 0.0, 1.0, dd_c)
      better = t_c[:, 0] < best_t
      best_t = torch.where(better, t_c[:, 0], best_t)
      best_tri = torch.where(better, s + idx_c[:, 0], best_tri)
      best_u = torch.where(better, a_c * inv, best_u)
      best_v = torch.where(better, b_c * inv, best_v)
    t_out[sl], tri_out[sl], u_out[sl], v_out[sl] = best_t, best_tri, best_u, best_v
  return Hit(t_out, tri_out, u_out, v_out)


def occluded_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> torch.Tensor:
  """Any valid pair, as `_kernel_brute2_anyhit`: OR over every chunk."""
  num_t = tri_v0.shape[0]
  e1, e2 = _folded(tri_e1, tri_e2, tri_mask)
  occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
  for sl, ray in _ray_tiles(o, d, t_min, t_max):
    hit = occ[sl]
    for s in range(0, num_t, CHUNK):
      c = slice(s, s + CHUNK)
      hit = hit | _pairs(tri_v0[c], e1[c], e2[c], ray)[0].any(dim=1)
    occ[sl] = hit
  return occ


# ------------------------------------------------------------------ the kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_COMMON = [_P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I]
_lib = None


def _library():
  global _lib
  if _lib is None:
    lib = _build.load("brute2_trace")
    lib.etx_brute2_intersect.argtypes = _COMMON + [_P, _P, _P, _P, _P]
    lib.etx_brute2_intersect.restype = _I
    lib.etx_brute2_occluded.argtypes = _COMMON + [_P, _P]
    lib.etx_brute2_occluded.restype = _I
    lib.etx_brute2_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.etx_brute2_occupancy.restype = _I
    lib.etx_brute2_error_string.argtypes = [_I]
    lib.etx_brute2_error_string.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def _check(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask):
  return brute_trace._check(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask,
                            what="pair-tile")


def occupancy(num_t: int, any_hit: bool) -> int:
  """Blocks of the kernel that one SM holds at once for a table of num_t
  triangles (its registers and shared memory decide), by the CUDA runtime's
  occupancy calculator on the current device."""
  blocks = _I(0)
  _raise_on(_library().etx_brute2_occupancy(num_t, int(any_hit), ctypes.byref(blocks)),
            "occupancy")
  return blocks.value


def _raise_on(rc: int, what: str):
  if rc != 0:
    msg = _library().etx_brute2_error_string(rc).decode()
    raise RuntimeError(f"brute2_trace {what} kernel launch failed: {msg} (cudaError {rc})")


def intersect(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> Hit:
  """Closest hit of each ray: Hit(t, tri, u, v). K3 on CUDA tensors, the
  plain version on CPU tensors."""
  if o.device.type == "cpu":
    return intersect_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask)
  num_t, num_r = _check(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask)
  t = torch.empty(num_r, dtype=torch.float32, device=o.device)
  tri = torch.empty(num_r, dtype=torch.int32, device=o.device)
  u = torch.empty(num_r, dtype=torch.float32, device=o.device)
  v = torch.empty(num_r, dtype=torch.float32, device=o.device)
  if num_r == 0:
    return Hit(t, tri, u, v)
  lib = _library()
  with torch.cuda.device(o.device):
    stream = torch.cuda.current_stream(o.device).cuda_stream
    rc = lib.etx_brute2_intersect(
        *brute_trace._common_args(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask,
                                  num_t, num_r),
        t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(), stream)
  _raise_on(rc, "intersect")
  launches["intersect"] += 1
  return Hit(t, tri, u, v)


def occluded(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> torch.Tensor:
  """Any-hit occlusion of each ray: (R,) bool. K4 on CUDA tensors, the plain
  version on CPU tensors."""
  if o.device.type == "cpu":
    return occluded_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask)
  num_t, num_r = _check(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask)
  occ = torch.empty(num_r, dtype=torch.bool, device=o.device)
  if num_r == 0:
    return occ
  lib = _library()
  with torch.cuda.device(o.device):
    stream = torch.cuda.current_stream(o.device).cuda_stream
    rc = lib.etx_brute2_occluded(
        *brute_trace._common_args(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask,
                                  num_t, num_r),
        occ.data_ptr(), stream)
  _raise_on(rc, "occluded")
  launches["occluded"] += 1
  return occ
