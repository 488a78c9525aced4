"""Build the CUDA sources under `csrc/` into shared libraries, at first use.

Each source has a plain C interface and includes no PyTorch header, so one
nvcc call per source builds it in seconds; the wrappers load the library with
ctypes. Libraries go to `etx_tracer_tpu_torch/_build/` (listed in
.gitignore), named by a digest of the source and the flags, so an edit to
either builds anew and an unchanged source is built once. Nothing is built
when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Hopper only; -fmad=false and no fast math keep each kernel's rounding equal
# to its plain PyTorch version's; -Xptxas -v reports registers and spills.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# every kernel source of the package, by library name
SOURCES = {"brute_trace": "brute_trace.cu", "brute2_trace": "brute2_trace.cu",
           "bvh_trace": "bvh_trace.cu", "woop_trace": "woop_trace.cu"}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
  """Path of nvcc: $CUDA_HOME/bin, else PATH, else the toolkit's default place."""
  home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
  if home and (Path(home) / "bin" / "nvcc").exists():
    return str(Path(home) / "bin" / "nvcc")
  found = shutil.which("nvcc")
  if found:
    return found
  default = Path("/usr/local/cuda/bin/nvcc")
  if default.exists():
    return str(default)
  raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
  src = SRC_DIR / SOURCES[name]
  digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
  return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict:
  """Build the named sources (default: all) that are not built yet, one nvcc
  process per source, all started together. Returns {name: (seconds, log)}
  for the sources it built; raises RuntimeError with nvcc's output if one
  fails."""
  names = list(SOURCES) if names is None else list(names)
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  procs = {}
  for name in names:
    out = library_path(name)
    if out.exists():
      continue
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / SOURCES[name])]
    procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True), tmp, out, time.perf_counter())
  results, failed = {}, []
  for name, (proc, tmp, out, t0) in procs.items():
    log, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
      failed.append(f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n{log}")
      continue
    os.replace(tmp, out)
    results[name] = (seconds, log)
  if failed:
    raise RuntimeError("\n".join(failed))
  return results


def load(name: str) -> ctypes.CDLL:
  """The built library `name`, building it first if needed."""
  lib = _loaded.get(name)
  if lib is None:
    build_all([name])
    lib = ctypes.CDLL(str(library_path(name)))
    _loaded[name] = lib
  return lib
