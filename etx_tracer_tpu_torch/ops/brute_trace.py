"""Brute-force ray/triangle intersection, for any triangle count.

Two functions, each a CUDA kernel (`csrc/brute_trace.cu`) with a plain
PyTorch version of the same signature beside it:

- `intersect` (K1): closest hit, the port of the TPU kernel
  `etx_tracer_tpu/ops/pallas_trace.py:intersect_pallas`;
- `occluded` (K2): any hit, the port of `pallas_trace.occluded_pallas`.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. The plain versions give the result of
`etx_tracer_tpu/ops/trace.py:intersect_scan`'s per-triangle loop with its
expressions, evaluated on tiles of rays x chunks of triangles; the CPU tests
hold them against the JAX package and `chip_smoke.py` holds each kernel
against them on the card.

The kernels skip a ray that can have no valid pair (`dead_lanes`: an
empty or NaN interval, or t_max < 0, as the main path's dead lanes and
missing shadow rays have) and write its miss at once; the plain versions
test it and find no valid pair, so the outputs are the same.

The trace dispatch (`ops/trace.py`) sends scenes of at most 128 triangles
here, as the JAX package does; the kernels, like the TPU kernels, take any
count (the micro-benchmark runs K1 on bigscene's 15,396 triangles).

`launches` counts kernel launches (never plain calls), so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from etx_tracer_tpu_torch.ops import _build

_MT_EPS = 1e-9
# ray-triangle pairs a chunk of the plain versions holds: on the CPU a
# chunk's temporaries stay in cache (past 2^14 rays a chunk is one
# triangle), on the card a chunk takes fewer launches
_PAIRS = {"cpu": 1 << 14, "cuda": 1 << 22}

launches = {"intersect": 0, "occluded": 0}


class Hit(NamedTuple):
  t: torch.Tensor    # (R,) float32, +inf when missed
  tri: torch.Tensor  # (R,) int32, -1 when missed
  u: torch.Tensor    # (R,) barycentric u
  v: torch.Tensor    # (R,) barycentric v

  @property
  def found(self):
    return self.tri >= 0


# --------------------------------------------------------------- plain versions


def dead_lanes(t_min, t_max):
  """The kernels' skip test, (R,) bool: !(t_min <= t_max) or t_max < 0,
  compared in float32 as the kernels compare. No rounded t satisfies both
  t >= t_min and t <= t_max when t_max < t_min or a bound is NaN, and the
  plain versions drop a ray with t_max < 0 (the proof is in
  csrc/brute_trace.cu)."""
  return ~(t_min <= t_max) | (t_max < 0.0)


def _tri_chunks(tri_v0, tri_e1, tri_e2, tri_mask, num_r):
  """(triangle indices (C,) int32, nine (1, C) rows: v0, e1, e2 by
  component) per chunk of the triangles the mask keeps, in index order, a
  chunk of at most _PAIRS ray-triangle pairs."""
  rows = torch.cat([tri_v0, tri_e1, tri_e2], dim=1)
  idx = torch.arange(rows.shape[0], dtype=torch.int32, device=rows.device)
  if tri_mask is not None:
    idx = idx[tri_mask]
    rows = rows[tri_mask]
  step = max(1, _PAIRS.get(rows.device.type, _PAIRS["cuda"]) // max(num_r, 1))
  for c0 in range(0, rows.shape[0], step):
    yield idx[c0:c0 + step], rows[c0:c0 + step].t().unsqueeze(1).unbind(0)


def _mt(row, ox, oy, oz, dx, dy, dz, t_min, t_max):
  """Möller-Trumbore of every ray against one triangle: (ok, t, u, v)."""
  v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row
  px = dy * e2z - dz * e2y
  py = dz * e2x - dx * e2z
  pz = dx * e2y - dy * e2x
  det = px * e1x + py * e1y + pz * e1z
  det_ok = torch.abs(det) > _MT_EPS
  inv_det = torch.where(det_ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
  tx = ox - v0x
  ty = oy - v0y
  tz = oz - v0z
  u = (tx * px + ty * py + tz * pz) * inv_det
  qx = ty * e1z - tz * e1y
  qy = tz * e1x - tx * e1z
  qz = tx * e1y - ty * e1x
  v = (dx * qx + dy * qy + dz * qz) * inv_det
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
  ok = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t >= t_min) & (t <= t_max))
  return ok, t, u, v


def intersect_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> Hit:
  """Closest hit, the lowest index winning a tie: the result of a loop over
  the triangles carrying the running best with strict t < best_t, taken
  over chunks of triangles (each pair's expressions are the loop's): a
  chunk's lowest index with the least t, then strict < across chunks."""
  num_r = o.shape[0]
  ray = [x[:, None] for x in (*o.unbind(1), *d.unbind(1), t_min, t_max)]
  live = (t_max >= 0.0)[:, None]
  best_t = torch.full((num_r,), float("inf"), dtype=torch.float32, device=o.device)
  best_tri = torch.full((num_r,), -1, dtype=torch.int32, device=o.device)
  best_u = torch.zeros(num_r, dtype=torch.float32, device=o.device)
  best_v = torch.zeros(num_r, dtype=torch.float32, device=o.device)
  for idx, row in _tri_chunks(tri_v0, tri_e1, tri_e2, tri_mask, num_r):
    ok, t, u, v = _mt(row, *ray)
    ok = ok & live
    if t.shape[1] == 1:
      tri = idx
      ok, t, u, v = ok[:, 0], t[:, 0], u[:, 0], v[:, 0]
    else:
      # the chunk's lowest index with its least valid t (none: inf, taken by
      # no ray, as no t < inf is)
      least = torch.where(ok, t, float("inf")).amin(dim=1, keepdim=True)
      first = (ok & (t == least)).to(torch.uint8).argmax(dim=1, keepdim=True)
      tri = idx[first[:, 0]]
      ok = least[:, 0] < float("inf")
      t, u, v = (x.gather(1, first)[:, 0] for x in (t, u, v))
    take = ok & (t < best_t)
    best_t = torch.where(take, t, best_t)
    best_tri = torch.where(take, tri, best_tri)
    best_u = torch.where(take, u, best_u)
    best_v = torch.where(take, v, best_v)
  return Hit(best_t, best_tri, best_u, best_v)


def occluded_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> torch.Tensor:
  """Any hit with t in [t_min, t_max], OR-accumulated over the triangles."""
  ray = [x[:, None] for x in (*o.unbind(1), *d.unbind(1), t_min, t_max)]
  occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
  for _, row in _tri_chunks(tri_v0, tri_e1, tri_e2, tri_mask, o.shape[0]):
    occ = occ | _mt(row, *ray)[0].any(dim=1)
  return occ & (t_max >= 0.0)


# ------------------------------------------------------------------ the kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_COMMON = [_P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I]
_lib = None


def bind(lib):
  """Sets the argument and result types of a built `csrc/brute_trace.cu`
  library's entries and returns it; an earlier source's library, which may
  lack `etx_brute_launch_shape`, binds too."""
  lib.etx_brute_intersect.argtypes = _COMMON + [_P, _P, _P, _P, _P]
  lib.etx_brute_intersect.restype = _I
  lib.etx_brute_occluded.argtypes = _COMMON + [_P, _P]
  lib.etx_brute_occluded.restype = _I
  if hasattr(lib, "etx_brute_launch_shape"):
    lib.etx_brute_launch_shape.argtypes = [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.etx_brute_launch_shape.restype = _I
  lib.etx_cuda_error_string.argtypes = [_I]
  lib.etx_cuda_error_string.restype = ctypes.c_char_p
  return lib


def _library():
  global _lib
  if _lib is None:
    _lib = bind(_build.load("brute_trace"))
  return _lib


def _check(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask, what="brute-force"):
  """Validate what the kernels take; returns (num_t, num_r)."""
  dev = o.device
  if dev.type != "cuda":
    raise ValueError(f"the {what} kernels take CUDA tensors, got {dev}")
  num_t, num_r = tri_v0.shape[0], o.shape[0]
  for name, x, shape in (("tri_v0", tri_v0, (num_t, 3)), ("tri_e1", tri_e1, (num_t, 3)),
                         ("tri_e2", tri_e2, (num_t, 3)), ("o", o, (num_r, 3)),
                         ("d", d, (num_r, 3)), ("t_min", t_min, (num_r,)),
                         ("t_max", t_max, (num_r,))):
    if x.device != dev:
      raise ValueError(f"{name} is on {x.device}, rays are on {dev}")
    if x.dtype != torch.float32:
      raise ValueError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
      raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
  for name, x in (("tri_v0", tri_v0), ("tri_e1", tri_e1), ("tri_e2", tri_e2),
                  ("t_min", t_min), ("t_max", t_max)):
    if not x.is_contiguous():
      raise ValueError(f"{name} must be contiguous")
  if tri_mask is not None:
    if (tri_mask.device != dev or tri_mask.dtype != torch.bool
        or tuple(tri_mask.shape) != (num_t,) or not tri_mask.is_contiguous()):
      raise ValueError("tri_mask must be a contiguous (T,) bool tensor on the rays' device")
  return num_t, num_r


def _raise_on(rc: int, what: str, lib=None):
  if rc != 0:
    msg = (lib or _library()).etx_cuda_error_string(rc).decode()
    raise RuntimeError(f"brute_trace {what} kernel launch failed: {msg} (cudaError {rc})")


def _common_args(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask, num_t, num_r):
  return [tri_v0.data_ptr(), tri_e1.data_ptr(), tri_e2.data_ptr(),
          None if tri_mask is None else tri_mask.data_ptr(), num_t,
          o.data_ptr(), o.stride(0), o.stride(1),
          d.data_ptr(), d.stride(0), d.stride(1),
          t_min.data_ptr(), t_max.data_ptr(), num_r]


def launch_with(lib, entry, tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None):
  """K1 (entry "intersect": a Hit) or K2 ("occluded": (R,) bool) of a bound
  library (`bind`) on CUDA tensors, on the current stream; counts no
  launch. `intersect` and `occluded` call it with this source's library."""
  num_t, num_r = _check(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask)
  dev = o.device
  if entry == "intersect":
    outs = [torch.empty(num_r, dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
  else:
    outs = [torch.empty(num_r, dtype=torch.bool, device=dev)]
  if num_r > 0:
    with torch.cuda.device(dev):
      stream = torch.cuda.current_stream(dev).cuda_stream
      fn = lib.etx_brute_intersect if entry == "intersect" else lib.etx_brute_occluded
      rc = fn(*_common_args(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask, num_t, num_r),
              *(x.data_ptr() for x in outs), stream)
    _raise_on(rc, entry, lib)
  return Hit(*outs) if entry == "intersect" else outs[0]


def launch_shape(num_t: int, num_r: int, any_hit: bool) -> tuple[int, int]:
  """(blocks per SM, rays a block) of K2 (any_hit) or K1 for num_r rays
  against num_t triangles on the current device: each block of 256
  threads takes that many consecutive rays, and the launch has
  ceil(num_r / rays a block) blocks."""
  blocks, tile = _I(0), _I(0)
  _raise_on(_library().etx_brute_launch_shape(num_t, num_r, int(any_hit), ctypes.byref(blocks),
                                              ctypes.byref(tile)), "launch shape")
  return blocks.value, tile.value


def intersect(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> Hit:
  """Closest hit of each ray: Hit(t, tri, u, v). K1 on CUDA tensors, the
  plain version on CPU tensors."""
  if o.device.type == "cpu":
    return intersect_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask)
  hit = launch_with(_library(), "intersect", tri_v0, tri_e1, tri_e2, o, d, t_min, t_max,
                    tri_mask)
  if o.shape[0] > 0:
    launches["intersect"] += 1
  return hit


def occluded(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask=None) -> torch.Tensor:
  """Any-hit occlusion of each ray: (R,) bool. K2 on CUDA tensors, the plain
  version on CPU tensors."""
  if o.device.type == "cpu":
    return occluded_plain(tri_v0, tri_e1, tri_e2, o, d, t_min, t_max, tri_mask)
  occ = launch_with(_library(), "occluded", tri_v0, tri_e1, tri_e2, o, d, t_min, t_max,
                    tri_mask)
  if o.shape[0] > 0:
    launches["occluded"] += 1
  return occ
