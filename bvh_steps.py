"""K5/K6 of this checkout against an earlier checkout's, and against a
sign-select slab, on one NVIDIA GPU.

    python3 bvh_steps.py [--parent DIR] [--sass DIR]

Builds `etx_tracer_tpu_torch/csrc/bvh_trace.cu` with the port's nvcc flags,
all builds started together: this checkout's source ("this tree"); the same
source with its slab test choosing each axis's near and far plane by the sign
of the ray's inverse direction in place of fminf/fmaxf ("sign-select slab",
SIGN_SLAB); with --parent, the source of an earlier checkout (DIR, a
`git archive`), whose K5/K6 entries take no scratch ("parent"). On bigscene's
tree it compares every build's K5 and K6 with the plain walk
(`ops/bvh_trace.py`) on every ray set below and fails if this tree's or the
parent's differs in one bit; the sign-select slab is reported either way.
Then it times K5 and K6 of each build on: every K5/K6 call of one iteration
of the bigscene main path at 512x512 (summed); 2^12, 2^16, 2^18 and 2^20
test rays from inside the room (`chip_smoke.test_rays`); the 1% of the 2^18
test rays whose plain walk makes the most steps; the closest-hit and shadow
rays of the main path's bounce 2 (`chip_smoke.capture_bounce`). A time is
`chip_smoke.kernel_ms`: the profiler's device time per call of the
`bvh_fat_kernel*` kernels (K6's pack and walk summed). The builds are timed
in turns, in order and then in reverse, and both times are printed.

Per build it prints ptxas's registers, shared bytes and stack frame for K5
and K6, the SASS instructions of the K5 and K6 functions, and those of one
fat row's step up to its leaves: a probe kernel, built around the source's
`box_hit`, that loads one row and tests both its boxes (for this tree's
sources with and without the parallel-axis override). --sass writes each
library's SASS to DIR.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from etx_tracer_tpu_torch.ops import _build, bvh_trace

# the slab lines of csrc/bvh_trace.cu, and the sign-select slab that the
# study puts in their place: for a box with mn <= mx and a finite nonzero iv
# (`safe_inv`) the same values, since rounding keeps the products' order
MINMAX_SLAB = """  const float t0 = (mn - o) * iv;
  const float t1 = (mx - o) * iv;
  lo = fminf(t0, t1);
  hi = fmaxf(t0, t1);
"""
SIGN_SLAB = """  const bool neg = iv < 0.0f;
  lo = ((neg ? mx : mn) - o) * iv;
  hi = ((neg ? mn : mx) - o) * iv;
"""
# one fat row's step up to its leaves: the row's four loads, cap, both box
# tests; BOX is the source's box test
PROBE = """
extern "C" __global__ void {name}(const int4* __restrict__ fat, const Ray* __restrict__ rays,
                                  int* __restrict__ out) {{
  const int i = threadIdx.x;
  const Ray r = rays[i];
  const int4* p = fat + 4 * (long long)out[i];
  const int4 q0 = __ldg(p);
  const int4 q1 = __ldg(p + 1);
  const int4 q2 = __ldg(p + 2);
  const int4 q3 = __ldg(p + 3);
  const float cap = fminf(r.tmax, bits(q3.w));
  const bool hit_l = {box}(r, bits(q0.x), bits(q0.y), bits(q0.z), bits(q0.w), bits(q1.x),
                           bits(q1.y), cap);
  const bool hit_r = {box}(r, bits(q1.z), bits(q1.w), bits(q2.x), bits(q2.y), bits(q2.z),
                           bits(q2.w), cap);
  out[i] = (hit_l ? q3.x : 0) + (hit_r ? q3.y : 0) + q3.z;
}}
"""
REPS = 20
_I = ctypes.c_int


def sources(parent: Path | None, out_dir: Path) -> dict:
  """{label: source path} of the builds."""
  src = _build.SRC_DIR / "bvh_trace.cu"
  text = src.read_text()
  if text.count(MINMAX_SLAB) != 1:
    raise RuntimeError("bvh_steps: the slab lines of csrc/bvh_trace.cu changed")
  sign = out_dir / "bvh_trace_sign.cu"
  sign.write_text(text.replace(MINMAX_SLAB, SIGN_SLAB))
  got = {"this tree": src, "sign-select slab": sign}
  if parent is not None:
    got = {"parent": parent / "etx_tracer_tpu_torch/csrc/bvh_trace.cu", **got}
  return got


def start_builds(srcs: dict, out_dir: Path) -> dict:
  """Starts nvcc for each library and each probe; {label: (library, probe
  cubin, [probe kernel names], [processes])}."""
  builds = {}
  for label, src in srcs.items():
    stem = re.sub(r"[^a-z0-9]+", "_", label)
    lib, cubin = out_dir / f"lib{stem}.so", out_dir / f"probe_{stem}.cubin"
    probe = out_dir / f"probe_{stem}.cu"
    templated = "template <bool kPar>\n__device__ __forceinline__ bool box_hit" in src.read_text()
    boxes = ({"row_par": "box_hit<true>", "row_nopar": "box_hit<false>"} if templated
             else {"row_par": "box_hit"})
    probe.write_text(f'#include "{src.resolve()}"\n' + "".join(
        PROBE.format(name=f"etx_probe_{k}", box=b) for k, b in boxes.items()))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = [subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
             subprocess.Popen([_build.nvcc(), *flags, "-cubin", "-o", str(cubin), str(probe)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    builds[label] = (lib, cubin, [f"etx_probe_{k}" for k in boxes], procs)
  return builds


def ptxas_usage(log: str) -> dict:
  """{'K5' | 'K6' | 'K6 pack': ptxas lines} for the fat-row kernels of a log."""
  usage, current = {}, None
  for line in log.splitlines():
    m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: |$)", line)
    if m:
      name = m.group(1)
      current = None
      if "bvh_fat_kernel_pack" in name:
        current = "K6 pack"
      elif "bvh_fat_kernel" in name:
        current = "K6" if "ILb1E" in name else "K5"
      continue
    if current and ("registers" in line or "stack frame" in line):
      usage.setdefault(current, []).append(line.split(":", 1)[-1].strip())
  return usage


def sass_counts(binary: Path, out: Path | None) -> dict:
  """{function: SASS instructions, NOPs left out} of a library or cubin."""
  text = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass", str(binary)],
                        capture_output=True, text=True, check=True).stdout
  if out is not None:
    out.write_text(text)
  counts, current = {}, None
  for line in text.splitlines():
    if "Function :" in line:
      current = line.split("Function :", 1)[1].strip()
      counts[current] = 0
    elif current and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S", line):
      counts[current] += 1
  return counts


def fat_counts(counts: dict) -> dict:
  """The K5/K6 functions' counts of `sass_counts`, by 'K5', 'K6', 'K6 pack'."""
  named = {}
  for name, n in counts.items():
    if "bvh_fat_kernel_pack" in name:
      named["K6 pack"] = n
    elif "bvh_fat_kernel" in name:
      named["K6" if "ILb1E" in name else "K5"] = n
  return named


def call(lib, with_scratch: bool, kind: str, bvh, rays):
  """K5 (kind 'closest') or K6 of a bound library on `rays`, as
  `ops/bvh_trace.py:_launch` calls this tree's; returns the outputs."""
  o, d, t_min, t_max = rays
  n, dev = o.shape[0], o.device
  if kind == "closest":
    outs = [torch.empty(n, dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
  else:
    outs = [torch.empty(n, dtype=torch.bool, device=dev)]
  scratch = [torch.empty(n + 2, dtype=torch.int32, device=dev)] if with_scratch else []
  fn = lib.etx_bvh_intersect_fat if kind == "closest" else lib.etx_bvh_occluded_fat
  rc = fn(bvh.fat_table.data_ptr(), bvh.prim_tris.data_ptr(), None,
          o.data_ptr(), o.stride(0), o.stride(1), d.data_ptr(), d.stride(0), d.stride(1),
          t_min.data_ptr(), t_max.data_ptr(), n, *(x.data_ptr() for x in [*outs, *scratch]),
          torch.cuda.current_stream(dev).cuda_stream)
  if rc != 0:
    raise RuntimeError(f"bvh_steps: launch failed: {lib.etx_bvh_error_string(rc).decode()}")
  return outs


def main_path_calls(scene, config, dev):
  """Every K5 and K6 call of one bigscene iteration (1 spp), as the trace
  dispatch receives them: [("closest" | "anyhit", (o, d, t_min, t_max))]."""
  from etx_tracer_tpu_torch.models import path_tracing
  from etx_tracer_tpu_torch.ops import trace as trace_ops
  calls = []
  orig = {kind: getattr(trace_ops, f"trace_{kind}") for kind in ("closest", "occluded")}

  def hook(kind):
    def trace(sc, o, d, t_min, t_max, tri_mask=None):
      calls.append(("closest" if kind == "closest" else "anyhit",
                    tuple(x.clone() for x in (o, d, t_min, t_max))))
      return orig[kind](sc, o, d, t_min, t_max, tri_mask)
    return trace

  try:
    for kind in orig:
      setattr(trace_ops, f"trace_{kind}", hook(kind))
    path_tracing.render_samples_static(scene, config, 0, 1, pool_size=1 << 18, device=dev)
  finally:
    for kind, fn in orig.items():
      setattr(trace_ops, f"trace_{kind}", fn)
  return calls


def ray_sets(rng, scene, dev, config):
  """[(label, kind, rays)]: the sets every build is checked and timed on."""
  sets = []
  for k in (12, 16, 18, 20):
    rays = chip_smoke.test_rays(rng, *scene[:3], 1 << k, dev, chip_smoke.ROOM)
    sets += [(f"2^{k} test rays", kind, rays) for kind in ("closest", "anyhit")]
    if k == 18:
      test = rays
  for kind, plain in (("closest", bvh_trace.intersect_fat_plain),
                      ("anyhit", bvh_trace.occluded_fat_plain)):
    zeros = lambda: torch.zeros(test[0].shape[0], dtype=torch.int64, device=dev)
    stats = {"boxes": 0, "tris": 0, "ray_rows": zeros(), "ray_tris": zeros()}
    plain(scene.bvh, *test, stats=stats)
    steps = stats["ray_rows"] + stats["ray_tris"]
    long = steps > steps.double().quantile(0.99)
    sets.append((f"the 2^18 test rays' longest 1% ({int(long.sum())})", kind,
                 [x[long].contiguous() for x in test]))
  closest, shadow = chip_smoke.capture_bounce(scene, config, dev, chip_smoke.CAPTURE_BOUNCE)
  sets += [("bounce 2", "closest", closest), ("bounce 2", "anyhit", shadow)]
  return sets


def main() -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--parent", type=Path, help="an earlier checkout whose K5/K6 take no scratch")
  ap.add_argument("--sass", type=Path, help="directory for each library's SASS")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("bvh_steps: no CUDA device; this script runs only on a GPU", file=sys.stderr)
    return 2
  dev = torch.device("cuda")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
  print(f"card: {smi.stdout.strip()}", flush=True)

  out_dir = _build.BUILD_DIR / "steps"
  out_dir.mkdir(parents=True, exist_ok=True)
  if args.sass is not None:
    args.sass.mkdir(parents=True, exist_ok=True)
  t0 = time.perf_counter()
  libs = {}
  for label, (lib, cubin, probes, procs) in start_builds(sources(args.parent, out_dir),
                                                         out_dir).items():
    logs = [p.communicate()[0] for p in procs]
    for p, log in zip(procs, logs):
      if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{log}")
    with_scratch = label != "parent"
    libs[label] = (bvh_trace.bind(ctypes.CDLL(str(lib)), scratch=with_scratch), with_scratch)
    stem = lib.stem
    whole = fat_counts(sass_counts(lib, args.sass / f"{stem}.sass" if args.sass else None))
    probe = sass_counts(cubin, None)
    note = " | ".join(f"{k}: " + "; ".join(v) for k, v in sorted(ptxas_usage(logs[0]).items()))
    note += f" | SASS instructions {whole}"
    note += " | one row's loads and box tests " + ", ".join(
        f"{name.removeprefix('etx_probe_')} {probe[name]}" for name in probes)
    if with_scratch:
      for any_hit in (False, True):
        blocks, threads = _I(0), _I(0)
        libs[label][0].etx_bvh_fat_occupancy(int(any_hit), ctypes.byref(blocks),
                                             ctypes.byref(threads))
        note += f" | {'K6' if any_hit else 'K5'} {blocks.value} blocks of {threads.value} an SM"
    print(f"build {label}: {note}", flush=True)
  print(f"built {len(libs)} libraries and probes in {time.perf_counter() - t0:.1f} s",
        flush=True)

  scene, config = chip_smoke.bigscene_scene((512, 512), dev)
  bvh = scene.bvh
  sets = ray_sets(np.random.default_rng(20261017), scene, dev, config)
  for label, (lib, with_scratch) in libs.items():
    differs = []
    for rays_label, kind, rays in sets:
      want = (list(bvh_trace.intersect_fat_plain(bvh, *rays)) if kind == "closest"
              else [bvh_trace.occluded_fat_plain(bvh, *rays)])
      got = call(lib, with_scratch, kind, bvh, rays)
      torch.cuda.synchronize()
      if not all(torch.equal(a, b) for a, b in zip(got, want)):
        differs.append(f"{kind} on {rays_label}")
    if label != "sign-select slab":
      chip_smoke.check(not differs, f"{label} differs from the plain walk: {differs}")
    print(f"{label}: " + (f"differs from the plain walk in {differs}" if differs
                          else "bit-equal to the plain walk on every ray set"), flush=True)

  calls = main_path_calls(scene, config, dev)
  sets += [("main path, one iteration's calls summed", kind,
            [rays for k, rays in calls if k == kind]) for kind in ("closest", "anyhit")]
  for rays_label, kind, rays in sets:
    many = isinstance(rays, list) and isinstance(rays[0], tuple)
    live = [float((~bvh_trace.dead_lanes(r[2], r[3])).float().mean()) for r in
            (rays if many else [rays])]
    print(f"rays {rays_label} {kind}: " + ", ".join(
        f"{r[0].shape[0]} lanes live {s:.4f}" for r, s in zip(rays if many else [rays], live)),
        flush=True)

  times = {}
  order = list(libs.items())
  for seq in (order, order[::-1]):
    for label, (lib, with_scratch) in seq:
      for rays_label, kind, rays in sets:
        many = isinstance(rays, list) and isinstance(rays[0], tuple)
        ms = sum(chip_smoke.kernel_ms(functools.partial(call, lib, with_scratch, kind, bvh, r),
                                      "bvh_fat_kernel", REPS)
                 for r in (rays if many else [rays]))
        times.setdefault((rays_label, kind), {}).setdefault(label, []).append(ms)
  for (rays_label, kind), by_label in times.items():
    print(f"{'K5' if kind == 'closest' else 'K6'} on {rays_label} (ms a call, in order / "
          f"reversed):", flush=True)
    for label, (a, b) in by_label.items():
      print(f"  {label:18s} {a:.4f} / {b:.4f}", flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
