"""BVH ray/triangle intersection for scenes above 4096 triangles.

Four functions, each a CUDA kernel (`csrc/bvh_trace.cu`) with a plain
PyTorch version of the same signature beside it:

- `intersect_fat` (K5): closest hit over the fat-node rows, the port of the
  TPU kernel `etx_tracer_tpu/ops/pallas_trace.py:intersect_bvh_fat_pallas`;
- `occluded_fat` (K6): any hit over the fat rows, the port of
  `pallas_trace.occluded_bvh_fat_pallas`;
- `intersect_node` (K7): closest hit over the plain pre-order nodes, the
  port of `pallas_trace.intersect_bvh_pallas`;
- `occluded_node` (K8): any hit over the plain nodes, the port of
  `pallas_trace.occluded_bvh_pallas`.

They compute what the TPU kernels compute, not their layout. A TPU kernel
walks one depth-first node stream shared by a tile of 128 x 8 rays (its
vector unit has no per-lane control flow), so a tile visits the union of
its rays' subtrees. Here each ray walks the same tree on its own in the
same left-first pre-order. Over the fat rows it walks a stack: a fat row
tests both children's boxes against min(t_max, best_t) (t_max for the any
hits), tests a leaf child's triangles in place (left, then right), then
descends into a hit left inner child, pushing a hit right inner child, or
goes to the hit right inner child, or pops. Over the plain nodes it walks
by skips, with no stack, as the TPU stream does: a node tests its box; a
hit leaf tests its triangles; the walk goes on to the next node after a
hit inner node or a leaf, to the node's skip after a missed inner node,
and ends past the last node (the source proves that this visits the nodes
a stack walk visits, in its order). A ray tests its leaves' triangles in
the order the shared stream would, a subsequence of it, with the triangle
test of `pallas_trace._tri_hit` and a strict `t < best_t`, so the same
triangle wins an exact tie. The any hits stop a ray at its first valid
triangle.

Box test: the slab with the axis-parallel intervals of the TPU kernels
(an axis with |d| < 1e-12 is all or nothing by the origin's position) and
the conservative `near <= far * 1.0000002 + 1e-7`.

The mask (by original triangle id) is read per tested triangle, as
`_tri_hit` ANDs it last. The kernels read the tables that
`ops/bvh_build.kernel_tables` builds once when the scene is frozen
(`BVH.fat_table`, `node_table`, `prim_tris`), with int32 ids and counts.

K5-K8 share one scheduler. They skip a ray whose interval is empty
(`dead_lanes`: !(t_min <= t_max), NaN included; such a ray has no valid
triangle, since a hit wants t_min <= t <= t_max) and write its miss at
once, and keep as many lanes of a warp busy as spread the live rays over
every warp, at most 32, so a small batch runs a few rays a warp. The
closest hits (K5, K7) run persistent warps that take rays from a queue and
refill a lane when its ray ends; the any hits (K6, K8) first pack the live
rays into a list (a second, small kernel) and their lanes walk fixed
strides of it. Each ray makes exactly the steps of the plain walk, so the
results are the same bits. The wrapper hands the kernels num_r + 2 ints of
scratch (the live count, the queue, the list), which the launch resets on
the stream, so a launch can be captured in a CUDA graph. The design notes
and numbers are in the source.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. The plain versions walk every ray at once,
vectorised over the rays that have not finished, and evaluate each
expression as the kernels do; `chip_smoke.py` holds each kernel against
them on the card, and the CPU tests hold them against the TPU kernels'
bodies run in interpret mode. `launches` counts kernel launches (never
plain calls), so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes

import torch

from etx_tracer_tpu_torch.ops import _build, brute_trace
from etx_tracer_tpu_torch.ops.brute_trace import Hit
from etx_tracer_tpu_torch.ops.bvh_build import STACK_DEPTH

_BIG = 3e38

launches = {"intersect_fat": 0, "occluded_fat": 0, "intersect_node": 0, "occluded_node": 0}


# --------------------------------------------------------------- plain versions


def dead_lanes(t_min, t_max):
  """(R,) bool: the rays K5-K8 skip, !(t_min <= t_max) (NaN included),
  compared in float32 as the kernels compare them. Such a ray has no valid
  triangle in any of the walks (a hit wants t_min <= t <= t_max); the
  kernels write its miss at once."""
  return ~(t_min <= t_max)


class _Rays:
  """Per-ray components, clamped inverse directions and parallel-axis flags."""

  def __init__(self, o, d, t_min, t_max):
    self.o = [o[:, k] for k in range(3)]
    self.d = [d[:, k] for k in range(3)]
    self.iv = [1.0 / torch.where(x.abs() < 1e-20, torch.where(x < 0.0, -1e-20, 1e-20), x)
               for x in self.d]
    self.par = [x.abs() < 1e-12 for x in self.d]
    self.t_min, self.t_max = t_min, t_max


def _box_hit(ray, idx, mn, mx, cap):
  """Slab test of the rays `idx` against (A, 3) boxes with far cap `cap`."""
  los, his = [], []
  for k in range(3):
    o, iv, par = ray.o[k][idx], ray.iv[k][idx], ray.par[k][idx]
    t0 = (mn[:, k] - o) * iv
    t1 = (mx[:, k] - o) * iv
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    inside = (o >= mn[:, k]) & (o <= mx[:, k])
    lo = torch.where(par, torch.where(inside, -_BIG, _BIG), lo)
    hi = torch.where(par, torch.where(inside, _BIG, -_BIG), hi)
    los.append(lo)
    his.append(hi)
  near = torch.maximum(torch.maximum(los[0], torch.maximum(los[1], los[2])), ray.t_min[idx])
  far = torch.minimum(torch.minimum(his[0], torch.minimum(his[1], his[2])), cap)
  return near <= far * 1.0000002 + 1e-7


def _tri_hit(ray, idx, row, best_t):
  """`pallas_trace._tri_hit` for the rays `idx` against their (A, 12)
  prim_tris rows: (ok, t, u, v, original id); the mask is ANDed by the
  caller. Its expressions are K1's (`brute_trace._mt`) with `t < best_t`."""
  ok, t, u, v = brute_trace._mt(row[:, :9].unbind(1), *(x[idx] for x in ray.o),
                                *(x[idx] for x in ray.d), ray.t_min[idx], ray.t_max[idx])
  return ok & (t < best_t), t, u, v, row[:, 9].view(torch.int32)


class _Best:
  """Per-ray results of a walk."""

  def __init__(self, num_r, dev):
    self.t = torch.full((num_r,), float("inf"), dtype=torch.float32, device=dev)
    self.tri = torch.full((num_r,), -1, dtype=torch.int32, device=dev)
    self.u = torch.zeros(num_r, dtype=torch.float32, device=dev)
    self.v = torch.zeros(num_r, dtype=torch.float32, device=dev)
    self.occ = torch.zeros(num_r, dtype=torch.bool, device=dev)


def _test_leaves(ray, best, idx, first, count, prim_tris, tri_mask, any_hit, stats):
  """Test each ray of `idx` against the `count` triangles of its leaf at
  prim_tris[first:], in order; an any-hit ray stops at its first valid
  triangle."""
  if idx.numel() == 0:
    return
  n = int(count.max().item())
  for k in range(n):
    live = count > k
    if any_hit:
      live = live & ~best.occ[idx]
    sel = live.nonzero()[:, 0]
    if sel.numel() == 0:
      break
    ids = idx[sel]
    row = prim_tris[(first[sel] + k).long()]
    ok, t, u, v, tid = _tri_hit(ray, ids, row, float("inf") if any_hit else best.t[ids])
    if tri_mask is not None:
      ok = ok & tri_mask[tid.long()]
    if stats is not None:
      stats["tris"] += int(sel.numel())
      if "ray_tris" in stats:
        stats["ray_tris"][ids] += 1
    if any_hit:
      best.occ[ids] = best.occ[ids] | ok
    else:
      best.t[ids] = torch.where(ok, t, best.t[ids])
      best.tri[ids] = torch.where(ok, tid, best.tri[ids])
      best.u[ids] = torch.where(ok, u, best.u[ids])
      best.v[ids] = torch.where(ok, v, best.v[ids])


def _walk(bvh, o, d, t_min, t_max, tri_mask, fat: bool, any_hit: bool, stats=None) -> _Best:
  """Every ray's walk at once (the plain version of K5-K8): a stack walk
  over the fat rows, a skip walk over the plain nodes."""
  num_r, dev = o.shape[0], o.device
  ray = _Rays(o, d, t_min, t_max)
  best = _Best(num_r, dev)
  table = bvh.fat_table if fat else bvh.node_table
  node = torch.zeros(num_r, dtype=torch.int32, device=dev)
  if fat:
    stack = torch.zeros((num_r, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.zeros(num_r, dtype=torch.int64, device=dev)
  act = torch.arange(num_r, device=dev)
  while act.numel() > 0:
    rows = table[node[act].long()]
    box = rows.view(torch.float32)
    cap = t_max[act] if any_hit else torch.minimum(t_max[act], best.t[act])
    if fat:
      hit_l = _box_hit(ray, act, box[:, 0:3], box[:, 3:6], cap)
      hit_r = _box_hit(ray, act, box[:, 6:9], box[:, 9:12], cap)
      first_l, first_r, counts = rows[:, 12], rows[:, 13], rows[:, 14]
      count_l, count_r = counts // 32, counts % 32
      leaf_l = hit_l & (count_l > 0)
      _test_leaves(ray, best, act[leaf_l], first_l[leaf_l], count_l[leaf_l],
                   bvh.prim_tris, tri_mask, any_hit, stats)
      leaf_r = hit_r & (count_r > 0)
      _test_leaves(ray, best, act[leaf_r], first_r[leaf_r], count_r[leaf_r],
                   bvh.prim_tris, tri_mask, any_hit, stats)
    else:
      hit = _box_hit(ray, act, box[:, 0:3], box[:, 3:6], cap)
      # word 6: a leaf's first triangle row, an inner node's skip
      word6, count = rows[:, 6], rows[:, 7]
      leaf = hit & (count > 0)
      _test_leaves(ray, best, act[leaf], word6[leaf], count[leaf],
                   bvh.prim_tris, tri_mask, any_hit, stats)
    if stats is not None:
      stats["boxes"] += (2 if fat else 1) * int(act.numel())
      if "ray_rows" in stats:
        stats["ray_rows"][act] += 1
    if not fat:
      # the skip walk: the next node after a hit inner node or a leaf, the
      # skip after a missed inner node; it ends past the last node (an
      # any-hit ray also at its first valid triangle)
      node[act] = torch.where(hit | (count > 0), node[act] + 1, word6)
      go_on = node[act] < table.shape[0]
      if any_hit:
        go_on = go_on & ~best.occ[act]
      act = act[go_on]
      continue
    down = hit_l & (count_l == 0)
    go_r = hit_r & (count_r == 0)
    push = down & go_r
    move = down | go_r
    if any_hit:
      move = move & ~best.occ[act]
    pa = act[push & move]
    stack[pa, sp[pa]] = first_r[push & move]
    sp[pa] += 1
    node[act[move]] = torch.where(down, first_l, first_r)[move]
    # a ray that moves on nowhere pops its stack, or has finished (as has
    # an occluded one)
    pop = ~move & (sp[act] > 0)
    if any_hit:
      pop = pop & ~best.occ[act]
    pa = act[pop]
    sp[pa] -= 1
    node[pa] = stack[pa, sp[pa]]
    act = act[move | pop]
  return best


def _check_plain(bvh, fat):
  if bvh is None or (fat and bvh.fat_table is None):
    raise ValueError("the scene's BVH has no fat rows" if bvh is not None else "no BVH")


def intersect_fat_plain(bvh, o, d, t_min, t_max, tri_mask=None, stats=None) -> Hit:
  """K5's walk over the fat rows: closest hit, Hit(t, tri, u, v); a miss is
  t = +inf, tri = -1, u = v = 0. `stats`, when given ({"boxes": 0,
  "tris": 0}), counts the box and triangle tests the walk makes; with
  (R,) int64 tensors under "ray_rows" and "ray_tris" it also adds each
  ray's rows (or nodes) and triangle tests to them."""
  _check_plain(bvh, True)
  b = _walk(bvh, o, d, t_min, t_max, tri_mask, fat=True, any_hit=False, stats=stats)
  return Hit(b.t, b.tri, b.u, b.v)


def occluded_fat_plain(bvh, o, d, t_min, t_max, tri_mask=None, stats=None) -> torch.Tensor:
  """K6's walk over the fat rows: (R,) bool, any valid triangle."""
  _check_plain(bvh, True)
  return _walk(bvh, o, d, t_min, t_max, tri_mask, fat=True, any_hit=True, stats=stats).occ


def intersect_node_plain(bvh, o, d, t_min, t_max, tri_mask=None, stats=None) -> Hit:
  """K7's walk over the plain nodes: closest hit, as `intersect_fat_plain`."""
  _check_plain(bvh, False)
  b = _walk(bvh, o, d, t_min, t_max, tri_mask, fat=False, any_hit=False, stats=stats)
  return Hit(b.t, b.tri, b.u, b.v)


def occluded_node_plain(bvh, o, d, t_min, t_max, tri_mask=None, stats=None) -> torch.Tensor:
  """K8's walk over the plain nodes: (R,) bool."""
  _check_plain(bvh, False)
  return _walk(bvh, o, d, t_min, t_max, tri_mask, fat=False, any_hit=True, stats=stats).occ


# ------------------------------------------------------------------ the kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
# table, prim_tris, mask, o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max, num_r
_COMMON = [_P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _I]
_ENTRIES = {"intersect_fat": "etx_bvh_intersect_fat", "occluded_fat": "etx_bvh_occluded_fat",
            "intersect_node": "etx_bvh_intersect_node", "occluded_node": "etx_bvh_occluded_node"}
_lib = None


def bind(lib, fat_scratch: bool = True, node_scratch: bool = True):
  """Sets the argument and result types of a built `csrc/bvh_trace.cu`
  library's entries and returns it. As this source's do (an earlier
  source's may not): `fat_scratch`, the fat entries take scratch and the
  library has `etx_bvh_fat_occupancy`; `node_scratch`, the node entries
  take the node count after the table and scratch, and the library has
  `etx_bvh_node_occupancy`."""
  for name, sym in _ENTRIES.items():
    fn = getattr(lib, sym)
    fat = name.endswith("fat")
    scratch = fat_scratch if fat else node_scratch
    head = _COMMON[:1] + ([] if fat or not scratch else [_I]) + _COMMON[1:]
    outs = [_P, _P, _P, _P] if name.startswith("intersect") else [_P]
    fn.argtypes = head + outs + ([_P] if scratch else []) + [_P]
    fn.restype = _I
  for form, scratch in (("fat", fat_scratch), ("node", node_scratch)):
    if scratch:
      fn = getattr(lib, f"etx_bvh_{form}_occupancy")
      fn.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
      fn.restype = _I
  lib.etx_bvh_error_string.argtypes = [_I]
  lib.etx_bvh_error_string.restype = ctypes.c_char_p
  return lib


def _library():
  global _lib
  if _lib is None:
    _lib = bind(_build.load("bvh_trace"))
  return _lib


def _check(bvh, fat, o, d, t_min, t_max, tri_mask):
  """Validate what the kernels take; returns (table, num_r)."""
  dev = o.device
  if dev.type != "cuda":
    raise ValueError(f"the BVH kernels take CUDA tensors, got {dev}")
  _check_plain(bvh, fat)
  table = bvh.fat_table if fat else bvh.node_table
  num_r = o.shape[0]
  for name, x, dtype, shape in (
      ("table", table, torch.int32, (table.shape[0], 16 if fat else 8)),
      ("prim_tris", bvh.prim_tris, torch.float32, (bvh.prim_tris.shape[0], 12)),
      ("o", o, torch.float32, (num_r, 3)), ("d", d, torch.float32, (num_r, 3)),
      ("t_min", t_min, torch.float32, (num_r,)), ("t_max", t_max, torch.float32, (num_r,))):
    if x.device != dev:
      raise ValueError(f"{name} is on {x.device}, rays are on {dev}")
    if x.dtype != dtype:
      raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
      raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
  for name, x in (("table", table), ("prim_tris", bvh.prim_tris), ("t_min", t_min),
                  ("t_max", t_max)):
    if not x.is_contiguous():
      raise ValueError(f"{name} must be contiguous")
  num_t = bvh.prim_tris.shape[0]
  if tri_mask is not None:
    if (tri_mask.device != dev or tri_mask.dtype != torch.bool
        or tuple(tri_mask.shape) != (num_t,) or not tri_mask.is_contiguous()):
      raise ValueError(f"tri_mask must be a contiguous ({num_t},) bool tensor on the rays' device")
  return table, num_r


def _raise_on(rc: int, what: str):
  if rc != 0:
    msg = _library().etx_bvh_error_string(rc).decode()
    raise RuntimeError(f"bvh_trace {what} kernel launch failed: {msg} (cudaError {rc})")


def _launch(name, bvh, o, d, t_min, t_max, tri_mask, outs):
  fat = name.endswith("fat")
  table, num_r = _check(bvh, fat, o, d, t_min, t_max, tri_mask)
  if num_r == 0:
    return
  lib = _library()
  # the scratch: the live count and the queue (reset by the launch on the
  # stream), then the list of live rays
  scratch = torch.empty(num_r + 2, dtype=torch.int32, device=o.device)
  # the node walk ends past the last node
  rows = [] if fat else [table.shape[0]]
  with torch.cuda.device(o.device):
    stream = torch.cuda.current_stream(o.device).cuda_stream
    rc = getattr(lib, _ENTRIES[name])(
        table.data_ptr(), *rows, bvh.prim_tris.data_ptr(),
        None if tri_mask is None else tri_mask.data_ptr(),
        o.data_ptr(), o.stride(0), o.stride(1), d.data_ptr(), d.stride(0), d.stride(1),
        t_min.data_ptr(), t_max.data_ptr(), num_r, *(x.data_ptr() for x in [*outs, scratch]),
        stream)
  _raise_on(rc, name)
  launches[name] += 1


def occupancy(fat: bool, any_hit: bool) -> tuple[int, int]:
  """(blocks per SM, threads per block) of K6 (fat, any_hit), K5 (fat), K8
  (any_hit) or K7 on the current device, by the CUDA runtime's occupancy
  calculator: K5-K8 launch that many blocks on every SM, or fewer for a
  small batch."""
  blocks, threads = _I(0), _I(0)
  fn = _library().etx_bvh_fat_occupancy if fat else _library().etx_bvh_node_occupancy
  _raise_on(fn(int(any_hit), ctypes.byref(blocks), ctypes.byref(threads)), "occupancy")
  return blocks.value, threads.value


def _intersect(name, plain, bvh, o, d, t_min, t_max, tri_mask) -> Hit:
  if o.device.type == "cpu":
    return plain(bvh, o, d, t_min, t_max, tri_mask)
  num_r = o.shape[0]
  hit = Hit(torch.empty(num_r, dtype=torch.float32, device=o.device),
            torch.empty(num_r, dtype=torch.int32, device=o.device),
            torch.empty(num_r, dtype=torch.float32, device=o.device),
            torch.empty(num_r, dtype=torch.float32, device=o.device))
  _launch(name, bvh, o, d, t_min, t_max, tri_mask, hit)
  return hit


def _occluded(name, plain, bvh, o, d, t_min, t_max, tri_mask) -> torch.Tensor:
  if o.device.type == "cpu":
    return plain(bvh, o, d, t_min, t_max, tri_mask)
  occ = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
  _launch(name, bvh, o, d, t_min, t_max, tri_mask, [occ])
  return occ


def intersect_fat(bvh, o, d, t_min, t_max, tri_mask=None) -> Hit:
  """Closest hit of each ray over the fat rows: K5 on CUDA tensors, the
  plain version on CPU tensors."""
  return _intersect("intersect_fat", intersect_fat_plain, bvh, o, d, t_min, t_max, tri_mask)


def occluded_fat(bvh, o, d, t_min, t_max, tri_mask=None) -> torch.Tensor:
  """Any-hit occlusion over the fat rows: K6 on CUDA tensors, the plain
  version on CPU tensors."""
  return _occluded("occluded_fat", occluded_fat_plain, bvh, o, d, t_min, t_max, tri_mask)


def intersect_node(bvh, o, d, t_min, t_max, tri_mask=None) -> Hit:
  """Closest hit over the plain nodes: K7 on CUDA tensors, the plain
  version on CPU tensors."""
  return _intersect("intersect_node", intersect_node_plain, bvh, o, d, t_min, t_max, tri_mask)


def occluded_node(bvh, o, d, t_min, t_max, tri_mask=None) -> torch.Tensor:
  """Any-hit occlusion over the plain nodes: K8 on CUDA tensors, the plain
  version on CPU tensors."""
  return _occluded("occluded_node", occluded_node_plain, bvh, o, d, t_min, t_max, tri_mask)
