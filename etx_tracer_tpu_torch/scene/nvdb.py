"""Binary NanoVDB (.nvdb) reader — float grids to dense numpy arrays.

The port's copy of `etx_tracer_tpu/scene/nvdb.py`, in place of the
reference's NanoVDB dependency
(sources/etx/render/host/medium_pool.cxx:102-160 `load_nvdb`): the reference
reads grid 0 as float and densifies the active voxels over the index
bounding box [min, max) into an x-fastest array. We parse the NanoVDB 32.x
ABI file format directly (layout per the published NanoVDB format docs;
ABI structs: GridData 672B / TreeData 64B / RootData(+32B tiles) /
InternalData 5^3,4^3 / LeafData 8^3) and return the same dense region as a
(dz, dy, dx) float32 array (the project's dense-grid convention).

Supported: uncompressed, ZIP, and BLOSC-compressed segments (the native
library's blosc1 decoder, `native/blosc_decoder.cpp`, covers the LZ4/zlib
inner codecs NanoVDB writes, IO.h:279-295), float grids (GridType::Float).
The reader runs on the host, once, when a scene is staged.
"""

from __future__ import annotations

import gzip
import struct
import zlib

import numpy as np

_MAGIC = 0x304244566F6E614E  # "NanoVDB0", little endian
_GRID_TYPE_FLOAT = 1

# struct sizes for the float-grid instantiation of the 32.x ABI
_FILE_HEADER = struct.Struct("<QIHH")        # magic, version, gridCount, codec
_FILE_META = struct.Struct("<4Q II 6d 6i 3d I 4I 3I HH I")  # 176 bytes
_GRID_DATA_SIZE = 672
_TREE_DATA_SIZE = 64
_ROOT_DATA_SIZE = 64     # 24B bbox + 4B tableSize + 5×4B stats, padded to 32B
_ROOT_TILE_SIZE = 32     # 8B key + 8B child + 4B state + 4B value, padded
_UPPER_LOG2 = 5
_LOWER_LOG2 = 4
_LEAF_LOG2 = 3
_LOWER_TOTAL = _LEAF_LOG2 + _LOWER_LOG2          # 7: lower node covers 128^3
_UPPER_TOTAL = _LOWER_TOTAL + _UPPER_LOG2        # 12: upper node covers 4096^3
_LEAF_SIZE = 96 + 4 * 512                        # 2144
# InternalData: bbox24 + flags8 + valueMask + childMask + stats16, table
# alignas(32); table entries are 8B unions (float value | int64 child offset)
_UPPER_MASK_BYTES = (1 << (3 * _UPPER_LOG2)) // 8   # 4096
_LOWER_MASK_BYTES = (1 << (3 * _LOWER_LOG2)) // 8   # 512
_UPPER_TABLE_OFF = 8256  # 32 + 2*4096 + 16 stats, rounded up to 32B
_LOWER_TABLE_OFF = 1088  # 32 + 2*512 + 16 stats, rounded up to 32B


def _bits(mask_bytes: bytes) -> np.ndarray:
  """Bitmask bytes -> bool array, bit i of word order = entry i."""
  return np.unpackbits(np.frombuffer(mask_bytes, np.uint8),
                       bitorder="little").astype(bool)


class NVDBError(RuntimeError):
  pass


def _decompress_segment(f, codec: int, grid_size: int) -> bytes:
  if codec == 0:  # NONE
    return f.read(grid_size)
  if codec == 1:  # ZIP: u64 compressed byte count + one zlib stream
    (csize,) = struct.unpack("<Q", f.read(8))
    return zlib.decompress(f.read(csize), bufsize=grid_size)
  if codec == 2:  # BLOSC: 1GB chunks, each u64 size + blosc1 frame
    from etx_tracer_tpu_torch import native
    parts = []
    done = 0
    while done < grid_size:
      (csize,) = struct.unpack("<Q", f.read(8))
      frame = f.read(csize)
      chunk = min(grid_size - done, 1 << 30)
      try:
        out = native.blosc_decompress(frame, chunk)
      except ValueError as e:
        raise NVDBError(f"BLOSC .nvdb segment: {e}") from e
      if out is None:  # no native toolchain: optional blosc package
        try:
          import blosc  # type: ignore
        except ImportError as e:
          raise NVDBError(
              ".nvdb uses BLOSC and neither the native decoder nor the "
              "`blosc` package is available") from e
        out = blosc.decompress(frame)
      parts.append(out)
      done += len(out)
    return b"".join(parts)
  raise NVDBError(f"unknown .nvdb codec {codec}")


def _read_first_float_grid(path: str) -> bytes:
  opener = gzip.open if path.endswith(".gz") else open
  with opener(path, "rb") as f:
    while True:
      hdr = f.read(_FILE_HEADER.size)
      if len(hdr) < _FILE_HEADER.size:
        raise NVDBError("no float grid found in .nvdb file")
      magic, _version, grid_count, codec = _FILE_HEADER.unpack(hdr)
      if magic != _MAGIC:
        raise NVDBError(f"bad .nvdb magic {magic:#x}")
      metas = []
      for _ in range(grid_count):
        m = _FILE_META.unpack(f.read(176))
        grid_size, grid_type, name_size = m[0], m[4], m[21]
        f.read(name_size)
        metas.append((grid_size, grid_type))
      for grid_size, grid_type in metas:
        buf = _decompress_segment(f, codec, grid_size)
        if grid_type == _GRID_TYPE_FLOAT:
          return buf
      # else: continue to next segment


def _key_to_coord(key: int) -> tuple[int, int, int]:
  """Root-tile key -> upper-node origin (21-bit fields, x high, z low)."""
  mask = (1 << 21) - 1
  return (((key >> 42) & mask) << _UPPER_TOTAL,
          ((key >> 21) & mask) << _UPPER_TOTAL,
          (key & mask) << _UPPER_TOTAL)


def _table_coords(log2dim: int, child_total: int, idx: np.ndarray):
  """Internal-node table index -> local voxel coords (x major, z minor)."""
  d = log2dim
  x = (idx >> (2 * d)) << child_total
  y = ((idx >> d) & ((1 << d) - 1)) << child_total
  z = (idx & ((1 << d) - 1)) << child_total
  return x, y, z


def _fill_box(dense, bmin, ox, oy, oz, size, value):
  """Fill a constant active-tile region clipped to the dense window."""
  dz, dy, dx = dense.shape
  x0, y0, z0 = ox - bmin[0], oy - bmin[1], oz - bmin[2]
  xs, xe = max(x0, 0), min(x0 + size, dx)
  ys, ye = max(y0, 0), min(y0 + size, dy)
  zs, ze = max(z0, 0), min(z0 + size, dz)
  if xs < xe and ys < ye and zs < ze:
    dense[zs:ze, ys:ye, xs:xe] = value


def read_nvdb_density(path: str) -> np.ndarray | None:
  """Densify grid 0 of a .nvdb file (medium_pool.cxx:102-160 semantics).

  Returns a (dz, dy, dx) float32 array over the index bbox [min, max),
  dims = max - min (the reference iterates exclusive of max), or None when
  the grid is empty/degenerate (matching the reference's clearing rules).
  """
  buf = _read_first_float_grid(path)
  gd = memoryview(buf)

  (magic,) = struct.unpack_from("<Q", gd, 0)
  if magic != _MAGIC:
    raise NVDBError("bad GridData magic")
  (grid_type,) = struct.unpack_from("<I", gd, 636)
  if grid_type != _GRID_TYPE_FLOAT:
    raise NVDBError(f"grid 0 is not a float grid (type {grid_type})")

  tree = _GRID_DATA_SIZE
  node_off = struct.unpack_from("<4Q", gd, tree)  # leaf, lower, upper, root
  root = tree + node_off[3]

  bbox = struct.unpack_from("<6i", gd, root)
  (table_size,) = struct.unpack_from("<I", gd, root + 24)
  bmin = bbox[:3]
  dims = tuple(bbox[3 + i] - bbox[i] for i in range(3))
  if min(dims) <= 0:
    return None
  dense = np.zeros((dims[2], dims[1], dims[0]), np.float32)

  tiles = np.frombuffer(gd, np.uint8, table_size * _ROOT_TILE_SIZE,
                        root + _ROOT_DATA_SIZE).reshape(table_size, _ROOT_TILE_SIZE)
  keys = tiles[:, 0:8].copy().view(np.uint64)[:, 0]
  children = tiles[:, 8:16].copy().view(np.int64)[:, 0]
  states = tiles[:, 16:20].copy().view(np.uint32)[:, 0]
  values = tiles[:, 20:24].copy().view(np.float32)[:, 0]

  for ti in range(table_size):
    ox, oy, oz = _key_to_coord(int(keys[ti]))
    child = int(children[ti])
    if child == 0:
      if states[ti]:  # active constant tile covering a full upper node
        _fill_box(dense, bmin, ox, oy, oz, 1 << _UPPER_TOTAL, values[ti])
      continue
    _read_upper(gd, root + child, ox, oy, oz, dense, bmin)

  # the reference keeps only strictly-positive voxels and clears degenerate
  # grids (medium_pool.cxx:131-158)
  np.maximum(dense, 0.0, out=dense)
  pos = dense[dense > 0.0]
  if pos.size == 0:
    return None
  if float(pos.max() - pos.min()) <= 1e-6 or float(pos.mean()) <= 1e-6:
    return None
  return dense


def _read_upper(gd, off, ox, oy, oz, dense, bmin):
  n = 1 << (3 * _UPPER_LOG2)
  vmask = _bits(bytes(gd[off + 32:off + 32 + _UPPER_MASK_BYTES]))
  cmask = _bits(bytes(gd[off + 32 + _UPPER_MASK_BYTES:
                         off + 32 + 2 * _UPPER_MASK_BYTES]))
  table = np.frombuffer(gd, np.uint8, n * 8, off + _UPPER_TABLE_OFF).reshape(n, 8)
  child_off = table.copy().view(np.int64)[:, 0]
  tile_val = table[:, 0:4].copy().view(np.float32)[:, 0]

  active = np.nonzero(vmask & ~cmask)[0]
  if active.size:
    xs, ys, zs = _table_coords(_UPPER_LOG2, _LOWER_TOTAL, active)
    for i in range(active.size):
      _fill_box(dense, bmin, ox + int(xs[i]), oy + int(ys[i]), oz + int(zs[i]),
                1 << _LOWER_TOTAL, tile_val[active[i]])
  for ci in np.nonzero(cmask)[0]:
    x, y, z = _table_coords(_UPPER_LOG2, _LOWER_TOTAL, np.asarray([ci]))
    _read_lower(gd, off + int(child_off[ci]),
                ox + int(x[0]), oy + int(y[0]), oz + int(z[0]), dense, bmin)


def _read_lower(gd, off, ox, oy, oz, dense, bmin):
  n = 1 << (3 * _LOWER_LOG2)
  vmask = _bits(bytes(gd[off + 32:off + 32 + _LOWER_MASK_BYTES]))
  cmask = _bits(bytes(gd[off + 32 + _LOWER_MASK_BYTES:
                         off + 32 + 2 * _LOWER_MASK_BYTES]))
  table = np.frombuffer(gd, np.uint8, n * 8, off + _LOWER_TABLE_OFF).reshape(n, 8)
  child_off = table.copy().view(np.int64)[:, 0]
  tile_val = table[:, 0:4].copy().view(np.float32)[:, 0]

  active = np.nonzero(vmask & ~cmask)[0]
  if active.size:
    xs, ys, zs = _table_coords(_LOWER_LOG2, _LEAF_LOG2, active)
    for i in range(active.size):
      _fill_box(dense, bmin, ox + int(xs[i]), oy + int(ys[i]), oz + int(zs[i]),
                1 << _LEAF_LOG2, tile_val[active[i]])
  for ci in np.nonzero(cmask)[0]:
    x, y, z = _table_coords(_LOWER_LOG2, _LEAF_LOG2, np.asarray([ci]))
    _read_leaf(gd, off + int(child_off[ci]),
               ox + int(x[0]), oy + int(y[0]), oz + int(z[0]), dense, bmin)


def _read_leaf(gd, off, ox, oy, oz, dense, bmin):
  vmask = _bits(bytes(gd[off + 16:off + 16 + 64]))
  vals = np.frombuffer(gd, np.float32, 512, off + 96)
  # leaf values are x-major/z-minor; dense is (z, y, x)
  grid = vals.reshape(8, 8, 8).transpose(2, 1, 0) * vmask.reshape(8, 8, 8).transpose(2, 1, 0)
  dz, dy, dx = dense.shape
  x0, y0, z0 = ox - bmin[0], oy - bmin[1], oz - bmin[2]
  xs, xe = max(x0, 0), min(x0 + 8, dx)
  ys, ye = max(y0, 0), min(y0 + 8, dy)
  zs, ze = max(z0, 0), min(z0 + 8, dz)
  if xs < xe and ys < ye and zs < ze:
    dense[zs:ze, ys:ye, xs:xe] = grid[zs - z0:ze - z0, ys - y0:ye - y0, xs - x0:xe - x0]
