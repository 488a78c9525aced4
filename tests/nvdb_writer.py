"""A JAX-free NanoVDB (.nvdb) writer for the port's tests and `chip_smoke.py`.

Writes minimal but layout-exact NanoVDB 32.x files (GridData 672 B,
TreeData 64 B, RootData 64 B + 32 B tiles, InternalData upper and lower
nodes, LeafData 2,144 B) in the NONE, ZIP or BLOSC codec (NanoVDB's blosc1
settings: LZ4, byte shuffle, typesize 4), the writer of
`tests/test_nvdb.py` copied, plus `write_dense`, which writes a dense
(gz, gy, gx) grid as one leaf per 8^3 block. It imports nothing of JAX or
of the JAX package: `chip_smoke.py` loads it by its path.
"""

import struct
import zlib

import numpy as np

_MAGIC = 0x304244566F6E614E
UP_T, LO_T, LF_T = 12, 7, 3  # node TOTAL log2 extents
def _mask_bytes(bits: np.ndarray) -> bytes:
  return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _leaf(origin, values, active):
  """LeafData: bboxmin 12 + dif/flags 4 + mask 64 + stats 16 + 512 floats."""
  buf = struct.pack("<3i", *origin)
  buf += b"\x00" * 4
  buf += _mask_bytes(active.reshape(-1))
  buf += struct.pack("<4f", 0, 0, 0, 0)
  assert len(buf) == 96
  buf += values.astype("<f4").tobytes()
  return buf


def _internal(log2dim, table_off, entries, origin):
  """InternalData: bbox 24 + flags 8 + vmask + cmask + stats + 8B table.

  entries: dict idx -> ("child", byte_offset) | ("tile", value, active)
  """
  n = 1 << (3 * log2dim)
  vmask = np.zeros(n, bool)
  cmask = np.zeros(n, bool)
  table = np.zeros((n, 8), np.uint8)
  for idx, e in entries.items():
    if e[0] == "child":
      cmask[idx] = True
      table[idx] = np.frombuffer(struct.pack("<q", e[1]), np.uint8)
    else:
      vmask[idx] = e[2]
      table[idx, 0:4] = np.frombuffer(struct.pack("<f", e[1]), np.uint8)
  buf = struct.pack("<6i", *origin, *(o + (1 << (log2dim + 2)) for o in origin))
  buf += struct.pack("<Q", 0)
  buf += _mask_bytes(vmask) + _mask_bytes(cmask)
  buf += struct.pack("<4f", 0, 0, 0, 0)
  buf += b"\x00" * (table_off - len(buf))
  buf += table.tobytes()
  return buf


def _coord_key(x, y, z):
  return ((x >> UP_T) << 42) | ((y >> UP_T) << 21) | (z >> UP_T)


def _table_idx(log2dim, child_total, x, y, z):
  d = log2dim
  lx = (x >> child_total) & ((1 << d) - 1)
  ly = (y >> child_total) & ((1 << d) - 1)
  lz = (z >> child_total) & ((1 << d) - 1)
  return (lx << (2 * d)) | (ly << d) | lz


def _write_nvdb(path, root_bbox, root_tiles, nodes, codec=0):
  """Assemble grid buffer: GridData|TreeData|Root|tiles|nodes (by offset)."""
  root_size = 64 + 32 * len(root_tiles)
  tree_off = 672
  root_rel = 64  # root immediately after TreeData
  node_blob = b"".join(nodes)
  grid_size = tree_off + 64 + root_size + len(node_blob)

  grid = struct.pack("<QQIIIIQ", _MAGIC, 0, (32 << 21) | (4 << 10) | 2, 0, 0, 1,
                     grid_size)
  grid += b"\x00" * 256                      # name
  grid += b"\x00" * 264                      # map
  grid += struct.pack("<6d", 0, 0, 0, 1, 1, 1)  # world bbox
  grid += struct.pack("<3d", 1, 1, 1)        # voxel size
  grid += struct.pack("<II", 1, 1)           # class=FogVolume, type=Float
  grid += struct.pack("<qIIQQ", 0, 0, 0, 0, 0)
  assert len(grid) == 672

  tree = struct.pack("<4Q", 0, 0, 0, root_rel)
  tree += struct.pack("<3I", 1, 1, 1) + struct.pack("<3I", 0, 0, 0)
  tree += struct.pack("<Q", 1)
  assert len(tree) == 64

  root = struct.pack("<6i", *root_bbox)
  root += struct.pack("<I", len(root_tiles))
  root += struct.pack("<5f", 0, 0, 0, 0, 0)
  root += b"\x00" * (64 - len(root))
  for key, child, state, value in root_tiles:
    root += struct.pack("<QqIf", key, child, state, value) + b"\x00" * 8

  buf = grid + tree + root + node_blob
  assert len(buf) == grid_size

  meta = struct.pack("<4Q", grid_size, grid_size, 0, 1)
  meta += struct.pack("<II", 1, 1)
  meta += struct.pack("<6d", 0, 0, 0, 1, 1, 1)
  meta += struct.pack("<6i", *root_bbox)
  meta += struct.pack("<3d", 1, 1, 1)
  meta += struct.pack("<I", 0)
  meta += struct.pack("<4I", 1, 1, 1, 1) + struct.pack("<3I", 0, 0, 0)
  meta += struct.pack("<HHI", codec, 0, 0)
  assert len(meta) == 176

  with open(path, "wb") as f:
    f.write(struct.pack("<QIHH", _MAGIC, (32 << 21) | (4 << 10) | 2, 1, codec))
    f.write(meta)
    if codec == 1:
      z = zlib.compress(buf)
      f.write(struct.pack("<Q", len(z)))
      f.write(z)
    elif codec == 2:  # BLOSC: u64 frame size + blosc1 frame (IO.h:279-295)
      frame = _blosc_frame(buf)
      f.write(struct.pack("<Q", len(frame)))
      f.write(frame)
    else:
      f.write(buf)


# --- minimal blosc1 writer (NanoVDB settings: LZ4, byte shuffle, ts=4) ---


def _lz4_block(data: bytes) -> bytes:
  """Legal LZ4 block: RLE match when possible, else literal-only."""
  n = len(data)
  if n >= 16 and data == data[:1] * n:
    # 1 literal + overlapping match of n-6, then a 5-literal tail
    mlen = n - 6
    out = bytearray()
    ml = mlen - 4
    out.append((1 << 4) | (15 if ml >= 15 else ml))
    out += data[:1]
    out += struct.pack("<H", 1)
    if ml >= 15:
      rem = ml - 15
      while rem >= 255:
        out.append(255)
        rem -= 255
      out.append(rem)
    out.append(5 << 4)  # final literal-only sequence
    out += data[1 + mlen:]
    return bytes(out)
  out = bytearray()
  out.append((15 if n >= 15 else n) << 4)
  if n >= 15:
    rem = n - 15
    while rem >= 255:
      out.append(255)
      rem -= 255
    out.append(rem)
  out += data
  return bytes(out)


def _shuffle_bytes(data: bytes, typesize: int) -> bytes:
  n = len(data) - len(data) % typesize
  planes = np.frombuffer(data[:n], np.uint8).reshape(-1, typesize)
  return planes.T.tobytes() + data[n:]


def _blosc_frame(data: bytes, typesize=4, blocksize=1 << 18, codec=1,
                 shuffle=True, memcpy=False) -> bytes:
  n = len(data)
  flags = (codec << 5) | (0x2 if memcpy else 0)
  if shuffle and typesize > 1 and not memcpy:
    flags |= 0x1
  if memcpy:
    head = struct.pack("<BBBBiii", 2, 1, flags, typesize, n, blocksize, 16 + n)
    return head + data
  nblocks = (n + blocksize - 1) // blocksize
  leftover = n % blocksize
  chunks = []
  starts = []
  pos = 16 + 4 * nblocks
  for j in range(nblocks):
    leftoverblock = (j == nblocks - 1) and leftover > 0
    bsize = leftover if leftoverblock else blocksize
    block = data[j * blocksize:j * blocksize + bsize]
    if flags & 0x1:
      block = _shuffle_bytes(block, typesize)
    nsplits = typesize if (typesize <= 16 and blocksize // typesize >= 128
                           and not leftoverblock) else 1
    neblock = bsize // nsplits
    starts.append(pos)
    enc = b""
    for s in range(nsplits):
      part = block[s * neblock:(s + 1) * neblock]
      comp = zlib.compress(part) if codec == 3 else _lz4_block(part)
      if len(comp) >= neblock:  # incompressible part: stored raw
        comp = part
      enc += struct.pack("<i", len(comp)) + comp
    chunks.append(enc)
    pos += len(enc)
  head = struct.pack("<BBBBiii", 2, 1, flags, typesize, n, blocksize, pos)
  return head + b"".join(struct.pack("<i", s) for s in starts) + b"".join(chunks)


def _single_leaf_file(path, codec=0):
  """One leaf at origin 0 with a checkable sparse pattern."""
  rs = np.random.RandomState(7)
  values = rs.rand(512).astype(np.float32) + 0.25
  active = rs.rand(512) < 0.5
  leaf = _leaf((0, 0, 0), values, active)
  # layout: [upper][lower][leaf]; child offsets are relative to each node
  up_size = 8256 + 32768 * 8
  lo_size = 1088 + 4096 * 8
  upper = _internal(5, 8256, {_table_idx(5, LO_T, 0, 0, 0): ("child", up_size)}, (0, 0, 0))
  lower = _internal(4, 1088, {_table_idx(4, LF_T, 0, 0, 0): ("child", lo_size)}, (0, 0, 0))
  root_size = 64 + 32
  # child offsets in root tiles are relative to the root node
  tiles = [(_coord_key(0, 0, 0), root_size, 1, 0.0)]
  _write_nvdb(path, (0, 0, 0, 8, 8, 8), tiles, [upper, lower, leaf], codec)
  dense_ref = np.where(active, values, 0.0).reshape(8, 8, 8).transpose(2, 1, 0)
  return dense_ref



def write_dense(path, dense, codec=2):
  """Write a dense (gz, gy, gx) float grid (each side at most 128) at index
  origin 0 as grid 0 of a .nvdb file: one upper and one lower node, a leaf
  for every 8^3 block that holds a nonzero voxel, every voxel of a leaf
  active. Returns the path."""
  dense = np.asarray(dense, np.float32)
  gz, gy, gx = dense.shape
  if max(gz, gy, gx) > 1 << LO_T:
    raise ValueError(f"write_dense takes sides of at most {1 << LO_T}, not {dense.shape}")
  up_size = 8256 + 32768 * 8
  lo_size = 1088 + 4096 * 8
  leaves, lower_entries = [], {}
  for z in range(0, gz, 8):
    for y in range(0, gy, 8):
      for x in range(0, gx, 8):
        block = np.zeros((8, 8, 8), np.float32)
        part = dense[z:z + 8, y:y + 8, x:x + 8]
        block[:part.shape[0], :part.shape[1], :part.shape[2]] = part
        if not block.any():
          continue
        # leaf values are x-major, z-minor
        vals = block.transpose(2, 1, 0).reshape(-1)
        lower_entries[_table_idx(4, LF_T, x, y, z)] = (
            "child", lo_size + len(leaves) * 2144)
        leaves.append(_leaf((x, y, z), vals, np.ones(512, bool)))
  lower = _internal(4, 1088, lower_entries, (0, 0, 0))
  upper = _internal(5, 8256, {_table_idx(5, LO_T, 0, 0, 0): ("child", up_size)}, (0, 0, 0))
  tiles = [(_coord_key(0, 0, 0), 64 + 32, 1, 0.0)]
  _write_nvdb(path, (0, 0, 0, gx, gy, gz), tiles, [upper, lower, *leaves], codec)
  return path
