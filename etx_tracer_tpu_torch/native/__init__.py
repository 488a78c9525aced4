"""The native host library: C++ built with g++ at first use, loaded with ctypes.

The port's copy of the JAX package's native layer (`etx_tracer_tpu/native`):
the same five sources, the same flags and the same entry points. It holds
the host code that is slow in Python, none of it device code:

- `build_bvh_native`: the binned-SAH BVH builder (`bvh_builder.cpp`);
- `parse_obj_native`: the OBJ geometry parser (`obj_parser.cpp`);
- `build_alias_tables`: batched Vose alias tables (`alias_builder.cpp`);
- `blosc_decompress`: blosc1 frames with LZ4 or zlib inside, as NanoVDB
  writes them (`blosc_decoder.cpp`);
- `piz_decode`, `piz_encode`: EXR PIZ blocks (`exr_decoder.cpp`).

`build` compiles all five into one library under `etx_tracer_tpu_torch/_build/`
(listed in .gitignore), named by a digest of the sources and the flags, as
`ops/_build.py` names the kernel libraries, so an edit builds anew and an
unchanged tree builds once. Nothing is built when a module is imported.
Every entry returns None when the library cannot be built (no g++, or no
zlib headers), and the callers then take their numpy or Python path, as
the JAX package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SOURCES = ("bvh_builder.cpp", "obj_parser.cpp", "blosc_decoder.cpp", "alias_builder.cpp",
           "exr_decoder.cpp")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lz"]

_lock = threading.Lock()
_lib = None
_failed: str | None = None


def library_path() -> Path:
  """Where the library for these sources and flags is built."""
  h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
  for name in SOURCES:
    h.update((_DIR / name).read_bytes())
  return BUILD_DIR / f"libetx_native-{h.hexdigest()[:16]}.so"


def build() -> float:
  """Build the library if it is not built yet. Returns the seconds g++
  took (0.0 when it was built already); raises RuntimeError with g++'s
  output when the build fails."""
  out = library_path()
  if out.exists():
    return 0.0
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
  cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *(str(_DIR / s) for s in SOURCES), *LIBS]
  t0 = time.perf_counter()
  try:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
  except (OSError, subprocess.TimeoutExpired) as e:
    raise RuntimeError(f"g++ failed to run: {e}") from e
  if proc.returncode != 0:
    raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
  os.replace(tmp, out)
  return time.perf_counter() - t0


def load():
  """The ctypes library, built first if needed; None when it cannot be
  built or loaded (`failure` says why)."""
  global _lib, _failed
  with _lock:
    if _lib is not None or _failed is not None:
      return _lib
    try:
      build()
      lib = ctypes.CDLL(str(library_path()))
    except (RuntimeError, OSError) as e:
      _failed = str(e)
      return None
    for name in ("etx_bvh_build", "etx_obj_parse", "etx_obj_counts", "etx_obj_data",
                 "etx_obj_material_name", "etx_obj_mtllib", "etx_alias_build"):
      getattr(lib, name).restype = ctypes.c_int32
    for name in ("etx_blosc_decompress", "etx_piz_decode", "etx_piz_encode"):
      getattr(lib, name).restype = ctypes.c_int64
    _lib = lib
    return _lib


def failure() -> str | None:
  """Why `load` gave None (g++'s message), or None."""
  return _failed


def _u8(a):
  return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a):
  return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32(a):
  return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_alias_tables(p: np.ndarray):
  """Batched Vose alias tables: p (rows, n) -> (prob, alias), or None."""
  lib = load()
  if lib is None:
    return None
  p = np.ascontiguousarray(p, np.float32)
  rows, n = p.shape
  prob = np.zeros((rows, n), np.float32)
  alias = np.zeros((rows, n), np.int32)
  if lib.etx_alias_build(_f32(p), ctypes.c_int32(rows), ctypes.c_int32(n), _f32(prob),
                         _i32(alias)) != 0:
    return None
  return prob, alias


def blosc_decompress(data: bytes, nbytes: int) -> bytes | None:
  """One blosc1 frame (LZ4 or zlib inside) decompressed to `nbytes` bytes;
  None without the library; ValueError on a malformed or unsupported
  frame."""
  lib = load()
  if lib is None:
    return None
  src = np.frombuffer(data, np.uint8)
  dst = np.zeros(max(nbytes, 1), np.uint8)
  n = lib.etx_blosc_decompress(_u8(src), ctypes.c_int64(src.size), _u8(dst),
                               ctypes.c_int64(dst.size))
  if n < 0:
    codes = {-1: "malformed blosc frame", -2: "output too small",
             -3: "unsupported inner codec (only LZ4/zlib)",
             -4: "bitshuffle filter unsupported", -5: "inner codec error"}
    raise ValueError(codes.get(int(n), f"blosc decode error {n}"))
  return dst[:n].tobytes()


def _piz_call(fn, data: bytes, ch_words, width: int, n_lines: int, dst_size: int):
  src = np.frombuffer(data, np.uint8)
  cw = np.ascontiguousarray(ch_words, np.int32)
  dst = np.zeros(max(dst_size, 1), np.uint8)
  n = fn(_u8(src), ctypes.c_int64(src.size), ctypes.c_int32(len(cw)), _i32(cw),
         ctypes.c_int32(width), ctypes.c_int32(n_lines), _u8(dst), ctypes.c_int64(dst.size))
  return n, dst


def piz_decode(data: bytes, ch_words, width: int, n_lines: int) -> bytes | None:
  """One PIZ scanline block decoded to the uncompressed block layout (per
  line, per channel, width * 2 * words bytes); ch_words: u16 words a pixel
  of each channel in file order (1 HALF, 2 FLOAT or UINT). None without the
  library; ValueError on malformed data."""
  lib = load()
  if lib is None:
    return None
  out_bytes = int(2 * width * int(np.sum(ch_words)) * n_lines)
  n, dst = _piz_call(lib.etx_piz_decode, data, ch_words, width, n_lines, out_bytes)
  if n < 0:
    codes = {-1: "malformed PIZ block", -2: "output too small", -3: "PIZ huffman error"}
    raise ValueError(codes.get(int(n), f"PIZ decode error {n}"))
  return dst[:n].tobytes()


def piz_encode(data: bytes, ch_words, width: int, n_lines: int) -> bytes | None:
  """One scanline block PIZ-compressed (the inverse of `piz_decode`); None
  without the library or when the data does not compress."""
  lib = load()
  if lib is None:
    return None
  n, dst = _piz_call(lib.etx_piz_encode, data, ch_words, width, n_lines,
                     len(data) * 2 + 65536 + 64)
  if n < 0:
    return None
  return dst[:n].tobytes()


def build_bvh_native(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
  """The binned-SAH tree of triangles (v0, v0 + e1, v0 + e2) as a dict of
  arrays (node_min, node_max, node_left, node_count, prim_index), or None."""
  lib = load()
  if lib is None:
    return None
  t = int(v0.shape[0])
  cap = max(2 * t, 1)
  node_min = np.zeros((cap, 3), np.float32)
  node_max = np.zeros((cap, 3), np.float32)
  node_left = np.zeros(cap, np.int32)
  node_count = np.zeros(cap, np.int32)
  prim_index = np.zeros(max(t, 1), np.int32)
  v0, e1, e2 = (np.ascontiguousarray(x, np.float32) for x in (v0, e1, e2))
  n = lib.etx_bvh_build(_f32(v0), _f32(e1), _f32(e2), ctypes.c_int32(t), _f32(node_min),
                        _f32(node_max), _i32(node_left), _i32(node_count), _i32(prim_index))
  if n <= 0:
    return None
  return {"node_min": node_min[:n].copy(), "node_max": node_max[:n].copy(),
          "node_left": node_left[:n].copy(), "node_count": node_count[:n].copy(),
          "prim_index": prim_index}


def parse_obj_native(path: str):
  """The geometry records of an OBJ file (positions, normals, uvs, fan-
  triangulated index triples, a material slot a triangle in order of first
  `usemtl`, the slot names and the mtllib), or None."""
  lib = load()
  if lib is None:
    return None
  if lib.etx_obj_parse(path.encode()) != 0:
    return None
  np_, nn, nt, ntri, nm = (ctypes.c_int32() for _ in range(5))
  lib.etx_obj_counts(ctypes.byref(np_), ctypes.byref(nn), ctypes.byref(nt), ctypes.byref(ntri),
                     ctypes.byref(nm))
  positions = np.zeros((max(np_.value, 1), 3), np.float32)
  normals = np.zeros((max(nn.value, 1), 3), np.float32)
  uvs = np.zeros((max(nt.value, 1), 2), np.float32)
  pos_idx, nrm_idx, uv_idx = (np.zeros(3 * max(ntri.value, 1), np.int32) for _ in range(3))
  tri_mtl = np.zeros(max(ntri.value, 1), np.int32)
  lib.etx_obj_data(_f32(positions), _f32(normals), _f32(uvs), _i32(pos_idx), _i32(nrm_idx),
                   _i32(uv_idx), _i32(tri_mtl))
  names = []
  buf = ctypes.create_string_buffer(1024)
  for i in range(nm.value):
    lib.etx_obj_material_name(ctypes.c_int32(i), buf, ctypes.c_int32(1024))
    names.append(buf.value.decode())
  lib.etx_obj_mtllib(buf, ctypes.c_int32(1024))
  mtllib = buf.value.decode()
  lib.etx_obj_free()
  k = 3 * ntri.value
  return {"positions": positions[:np_.value], "normals": normals[:nn.value],
          "uvs": uvs[:nt.value], "pos_idx": pos_idx[:k].reshape(-1, 3),
          "nrm_idx": nrm_idx[:k].reshape(-1, 3), "uv_idx": uv_idx[:k].reshape(-1, 3),
          "tri_mtl": tri_mtl[:ntri.value], "mtl_names": names, "mtllib": mtllib}
