"""Host-side BVH construction, flattened to arrays for the device.

The port's copy of `etx_tracer_tpu/ops/bvh_build.py` (`compute_skip`,
`build_fat_rows`, the binned-SAH `build_bvh`), so that both packages freeze
the same tree from the same triangles. Binned SAH over 16 bins, leaves of
at most 4 triangles, depth capped at 60, emitted as a flattened depth-first
2-wide tree: an inner node's left child is the next node (i+1) and
`node_left` stores the right child's index; a leaf stores the first entry
of its range of the reordered primitive list in `node_left`.

Builder choice, as in the JAX package: the native C++ builder
(`native/bvh_builder.cpp`, built with g++ at first use) when the library
builds, else the numpy one here (`build_bvh_numpy`). The two trees differ
in every array (node boxes, child links and primitive order) but hold the
same triangles; each is deterministic. `build_tree` says which one built a
tree, and `scene/builder.SceneBuilder` records it (`bvh_builder`). A test
that compares trees, tables or renders with the JAX package pins both
packages to one builder.

`kernel_tables` turns a tree in this layout into the tables the BVH kernels
read (`ops/bvh_trace.py`), once, when a scene is frozen. The fat-row
kernels walk the tree with a per-ray stack of `STACK_DEPTH` entries (one
per level below the root at most), so `kernel_tables` raises for a deeper
tree, wherever it was built; the node kernels walk by skips, with no
stack.
"""

from __future__ import annotations

import sys

import numpy as np

from etx_tracer_tpu_torch import native

_BINS = 16
_LEAF_SIZE = 4
_MAX_DEPTH = 60
# per-ray traversal stack of the BVH kernels (csrc/bvh_trace.cu kStackDepth),
# as the JAX package's trace._STACK_DEPTH
STACK_DEPTH = 64


def compute_skip(node_left: np.ndarray, node_count: np.ndarray) -> np.ndarray:
  """Pre-order skip offsets: skip[i] = first node after subtree(i)."""
  n = len(node_left)
  skip = np.zeros(n, np.int32)
  stack = [(0, n)]
  while stack:
    i, sk = stack.pop()
    skip[i] = sk
    if node_count[i] == 0 and n > 1:  # inner node
      right = int(node_left[i])
      stack.append((i + 1, right))  # left subtree ends where right begins
      stack.append((right, sk))
  return skip


def build_fat_rows(node_min, node_max, node_left, node_count):
  """Fat-node stream: inner nodes only, each row carrying BOTH children's
  boxes.

  Row components (16): minL(3), maxL(3), minR(3), maxR(3), L_first,
  R_first_or_start, counts = L_count*32 + R_count, skip. For an inner
  child the count is 0 and first is its fat-row index; leaf children are
  consumed in place (no stream entry). Returns (Ni, 16) float32, or None
  when the root is a leaf or a leaf holds 32 or more triangles (the count
  packing has 5 bits per child).
  """
  n = len(node_left)
  if n == 0 or node_count[0] > 0:
    return None
  if int(np.max(node_count)) >= 32:
    return None
  inner_ids = [i for i in range(n) if node_count[i] == 0]
  remap = {orig: new for new, orig in enumerate(inner_ids)}
  ni = len(inner_ids)
  rows = np.zeros((ni, 16), np.float32)

  # skip over the inner-only pre-order stream
  skip = np.zeros(ni, np.int32)
  stack = [(0, ni)]
  while stack:
    orig, sk = stack.pop()
    new = remap[orig]
    skip[new] = sk
    left, right = orig + 1, int(node_left[orig])
    if node_count[left] == 0:
      # the left subtree's stream ends where the right child's begins (or
      # at the parent's skip when the right child is a leaf)
      stack.append((left, remap[right] if node_count[right] == 0 else sk))
    if node_count[right] == 0:
      stack.append((right, sk))

  for orig in inner_ids:
    new = remap[orig]
    left, right = orig + 1, int(node_left[orig])
    lc = int(node_count[left])
    rc = int(node_count[right])
    rows[new, 0:3] = node_min[left]
    rows[new, 3:6] = node_max[left]
    rows[new, 6:9] = node_min[right]
    rows[new, 9:12] = node_max[right]
    rows[new, 12] = float(node_left[left]) if lc > 0 else float(remap[left])
    rows[new, 13] = float(node_left[right]) if rc > 0 else float(remap[right])
    rows[new, 14] = float(lc * 32 + rc)
    rows[new, 15] = float(skip[new])
  return rows


def tree_depth(node_left: np.ndarray, node_count: np.ndarray) -> int:
  """Edges on the longest root-to-leaf path."""
  n = len(node_left)
  depth = 0
  stack = [(0, 0)]
  while stack and n > 1:
    i, k = stack.pop()
    depth = max(depth, k)
    if node_count[i] == 0:
      stack.append((i + 1, k + 1))
      stack.append((int(node_left[i]), k + 1))
  return depth


def check_depth(node_left: np.ndarray, node_count: np.ndarray) -> int:
  """The tree's depth; raises ValueError when the kernels' stack is too
  shallow for it."""
  depth = tree_depth(node_left, node_count)
  if depth > STACK_DEPTH:
    raise ValueError(f"BVH depth {depth} exceeds the kernels' traversal stack of "
                     f"{STACK_DEPTH} entries")
  return depth


def build_tree(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
  """(the tree of triangles (v0, v0+e1, v0+e2) as `build_bvh` gives it, the
  builder that built it: "native" or "numpy")."""
  tree = native.build_bvh_native(v0, e1, e2)
  if tree is None:
    return build_bvh_numpy(v0, e1, e2), "numpy"
  tree["node_skip"] = compute_skip(tree["node_left"], tree["node_count"])
  tree["fat_rows"] = build_fat_rows(tree["node_min"], tree["node_max"], tree["node_left"],
                                    tree["node_count"])
  return tree, "native"


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> dict:
  """Build from triangle vertices (v0, v0+e1, v0+e2), natively when the
  native library builds, else in numpy. Returns a dict of arrays:
  node_min, node_max, node_left, node_count, prim_index, node_skip and
  fat_rows (None when the tree has no fat-row form)."""
  return build_tree(v0, e1, e2)[0]


def build_bvh_numpy(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> dict:
  """`build_bvh`'s tree built in numpy."""
  t = v0.shape[0]
  p1 = v0 + e1
  p2 = v0 + e2
  tri_min = np.minimum(np.minimum(v0, p1), p2)
  tri_max = np.maximum(np.maximum(v0, p1), p2)
  centroid = (tri_min + tri_max) * 0.5

  prim = np.arange(t, dtype=np.int32)

  node_min, node_max, node_left, node_count = [], [], [], []
  out_prims = []

  def add_node():
    node_min.append(np.zeros(3, np.float32))
    node_max.append(np.zeros(3, np.float32))
    node_left.append(0)
    node_count.append(0)
    return len(node_left) - 1

  def sah_split(ids):
    """Return (axis, threshold) by binned SAH, or None for a leaf."""
    c = centroid[ids]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    ext = cmax - cmin
    axis = int(np.argmax(ext))
    if ext[axis] <= 1e-12:
      return None
    rel = (c[:, axis] - cmin[axis]) / ext[axis]
    bins = np.minimum((rel * _BINS).astype(np.int32), _BINS - 1)
    best_cost, best_bin = np.inf, -1
    lo = tri_min[ids]
    hi = tri_max[ids]
    # each bin's bounds, then the bounds of bins [0, b) and [b, _BINS) by
    # running min / max (exact, so the split is the per-split masks' own)
    bin_lo = np.full((_BINS, 3), np.inf, lo.dtype)
    bin_hi = np.full((_BINS, 3), -np.inf, hi.dtype)
    np.minimum.at(bin_lo, bins, lo)
    np.maximum.at(bin_hi, bins, hi)
    left_lo, left_hi = np.minimum.accumulate(bin_lo), np.maximum.accumulate(bin_hi)
    right_lo = np.minimum.accumulate(bin_lo[::-1])[::-1]
    right_hi = np.maximum.accumulate(bin_hi[::-1])[::-1]
    left_n = np.cumsum(np.bincount(bins, minlength=_BINS))
    for b in range(1, _BINS):
      nl = int(left_n[b - 1])
      nr = len(ids) - nl
      if nl == 0 or nr == 0:
        continue
      lmin, lmax = left_lo[b - 1], left_hi[b - 1]
      rmin, rmax = right_lo[b], right_hi[b]

      def area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

      cost = area(lmin, lmax) * nl + area(rmin, rmax) * nr
      if cost < best_cost:
        best_cost, best_bin = cost, b
    if best_bin < 0:
      return None
    thresh = cmin[axis] + ext[axis] * best_bin / _BINS
    return axis, thresh

  def make_leaf(ni, ids):
    node_left[ni] = len(out_prims)
    node_count[ni] = len(ids)
    out_prims.extend(ids.tolist())
    return ni

  def recurse(ids, depth):
    ni = add_node()
    node_min[ni] = tri_min[ids].min(axis=0).astype(np.float32)
    node_max[ni] = tri_max[ids].max(axis=0).astype(np.float32)
    if len(ids) <= _LEAF_SIZE or depth >= _MAX_DEPTH:
      return make_leaf(ni, ids)
    split = sah_split(ids)
    if split is None:
      # median split on the largest axis
      c = centroid[ids]
      axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
      order = np.argsort(c[:, axis], kind="stable")
      mid = len(ids) // 2
      left_ids, right_ids = ids[order[:mid]], ids[order[mid:]]
    else:
      axis, thresh = split
      mask = centroid[ids, axis] < thresh
      left_ids, right_ids = ids[mask], ids[~mask]
    if len(left_ids) == 0 or len(right_ids) == 0:
      return make_leaf(ni, ids)
    # depth-first layout: the left child is ni+1, store the right child
    recurse(left_ids, depth + 1)
    ri = recurse(right_ids, depth + 1)
    node_left[ni] = ri
    node_count[ni] = 0
    return ni

  old_limit = sys.getrecursionlimit()
  sys.setrecursionlimit(10000)
  try:
    if t > 0:
      recurse(prim, 0)
    else:
      ni = add_node()
      node_min[ni] = np.zeros(3, np.float32)
      node_max[ni] = np.full(3, -1.0, np.float32)
      node_count[ni] = 0
  finally:
    sys.setrecursionlimit(old_limit)

  result = {
      "node_min": np.stack(node_min).astype(np.float32),
      "node_max": np.stack(node_max).astype(np.float32),
      "node_left": np.asarray(node_left, np.int32),
      "node_count": np.asarray(node_count, np.int32),
      "prim_index": np.asarray(out_prims if out_prims else [0], np.int32),
  }
  result["node_skip"] = compute_skip(result["node_left"], result["node_count"])
  result["fat_rows"] = build_fat_rows(
      result["node_min"], result["node_max"],
      result["node_left"], result["node_count"])
  return result


def kernel_tables(arrays) -> dict:
  """The BVH kernels' tables from a scene's numpy arrays: its tree in the
  layout above ("bvh.node_min", ..., "bvh.fat_rows" absent or None for a
  tree without fat rows) and its triangles ("tri_v0", "tri_e1", "tri_e2").

  Returns {"bvh.node_table": (N,8) int32 (min(3), max(3) as float32 bits,
  then for a leaf its first triangle row (node_left) and for an inner node
  its skip (`compute_skip`: the first node after its subtree; its left
  child is the next node), then count), "bvh.prim_tris": (T,12) float32
  (v0, e1, e2 of prim_index[j], its id as int32 bits, 2 zeros)} and, with
  fat rows, "bvh.fat_table": (Ni,16) int32 (the fat rows' boxes as float32
  bits, then L_first, R_first, counts, skip). The node kernels walk by the
  skips and need no right child: a leaf's skip is always its own index + 1.
  Ids and counts are int32 here, where the TPU tables carry them as
  float32. Raises ValueError for a tree deeper than the fat-row kernels'
  traversal stack.
  """
  i32, f32 = np.int32, np.float32
  node_left = np.asarray(arrays["bvh.node_left"], i32)
  node_count = np.asarray(arrays["bvh.node_count"], i32)
  check_depth(node_left, node_count)
  boxes = [np.ascontiguousarray(arrays[f"bvh.node_{k}"], f32).view(i32) for k in ("min", "max")]
  word6 = np.where(node_count > 0, node_left, compute_skip(node_left, node_count))
  tables = {"bvh.node_table": np.concatenate(
      boxes + [word6[:, None], node_count[:, None]], axis=1).astype(i32)}
  fat = arrays.get("bvh.fat_rows")
  if fat is not None:
    fat = np.asarray(fat, f32)
    tables["bvh.fat_table"] = np.concatenate(
        [np.ascontiguousarray(fat[:, :12]).view(i32), fat[:, 12:].astype(i32)], axis=1)
  prim = np.asarray(arrays["bvh.prim_index"], i32)
  tables["bvh.prim_tris"] = np.concatenate(
      [np.asarray(arrays[k], f32)[prim] for k in ("tri_v0", "tri_e1", "tri_e2")]
      + [prim[:, None].view(f32), np.zeros((prim.shape[0], 2), f32)], axis=1)
  return tables
