"""Trace kernels of this checkout against an earlier checkout's, in one
process on one NVIDIA GPU.

    python3 kernel_steps.py bvh [--parent DIR] [--sass DIR]
    python3 kernel_steps.py brute [--parent DIR] [--sass DIR]

Each family builds its kernel source with the port's nvcc flags, all builds
started together: this checkout's ("this tree"), variants of it made by
replacing lines of the source, and with --parent the source of an earlier
checkout (DIR, a `git archive`). It checks every build against the plain
versions on every ray set and fails if this tree's or the parent's differs
in one bit (a variant is reported either way), prints ptxas's registers,
shared bytes and stack frame and the SASS instructions of each kernel, and
times every build on every ray set in turns, in order and then in reverse,
both times printed. A time is `chip_smoke.kernel_ms`: the profiler's device
time per call of the family's kernels. --sass writes each library's SASS to
DIR.

`bvh`: K5/K6 (`csrc/bvh_trace.cu`) on bigscene's tree. The variant: each
slab choosing its axis's near and far plane by the sign of the ray's inverse
direction in place of fminf/fmaxf ("sign-select slab"). A library without
`etx_bvh_fat_occupancy` is bound as an earlier source's whose K5/K6 entries
take no scratch. Ray sets: every K5/K6 call of one iteration of the
bigscene main path at 512x512 (summed); 2^12, 2^16, 2^18 and 2^20 test rays
from inside the room (`chip_smoke.test_rays`); the 1% of the 2^18 test rays
whose plain walk makes the most steps; the closest-hit and shadow rays of
the main path's bounce 2 (`chip_smoke.capture_bounce`). It also counts the
SASS of one fat row's step up to its leaves: a probe kernel, built around
the source's `box_hit`, that loads one row and tests both its boxes (for
this tree's sources with and without the parallel-axis override).

`brute`: K1/K2 (`csrc/brute_trace.cu`) on the 512x512 Cornell box. The
variants: nvcc's own 1 / det ("division") or __frcp_rn ("frcp") in place of
the reciprocal without its branch; a pair skips q, v and t once u fails
("u reject"); K2's lanes of a ray vote after every row ("K2 votes a row");
every batch in tiles of 256 rays, however narrow ("one tile"); tiles as
small as give a full wave of blocks, not half ("full wave"); the lane loop
unrolled 4 times ("unroll 4"); registers bounded for 5 blocks an SM. Ray
sets: 2^18 test rays against the Cornell box's 36 triangles and a random
128-triangle soup; the closest-hit and shadow rays of the Cornell main
path's bounce 2; batches of 2^12, 2^14 and 2^16 live test rays; every
K1/K2 call of one Cornell main-path iteration (summed); K1 on 2^16 rays
against bigscene's 15,396 triangles (the micro `trace` group's shape). For
each kernel it counts the SASS of its loops: a loop whose body holds at
least one pair's 45 FADD/FMUL is reported with its instructions, and with
those over its pairs (FADD/FMUL over 45); a static count, which includes
code the loop holds but seldom runs (a slow path).
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
from etx_tracer_tpu_torch.ops import _build, brute_trace, bvh_trace
from etx_tracer_tpu_torch.scene import bigscene

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
# csrc/brute_trace.cu's lines that a K1/K2 variant replaces: (old, new)
U_LINE = "  u = (tx * px + ty * py + tz * pz) * inv_det;\n"
RCP_LINE = "  const float inv_det = reciprocal(det);\n"
LOOP = """    if (!done) {
      for (int j = k; j < m; j += lanes) {
        float t, u, v;
        const bool ok = mt(rows, j, r, t, u, v);
        if (kAnyHit) {
          if (ok) {
            done = true;
            break;
          }
        } else if (ok && t < best_t) {
"""
# K2's lanes vote after every row and stop together (K1 unchanged)
VOTE_LOOP = """    if (kAnyHit && lanes > 1) {
      const int steps = (m + lanes - 1) / lanes;
      for (int q = 0; q < steps; ++q) {
        const int j = q * lanes + k;
        bool ok = false;
        if (!done && j < m) {
          float t, u, v;
          ok = mt(rows, j, r, t, u, v);
        }
        const unsigned hits = __ballot_sync(kFull, ok);
        done = done || (hits & group_mask) != 0;
        if (__all_sync(kFull, done)) break;
      }
    } else if (!done) {
      for (int j = k; j < m; j += lanes) {
        float t, u, v;
        const bool ok = mt(rows, j, r, t, u, v);
        if (kAnyHit) {
          if (ok) {
            done = true;
            break;
          }
        } else if (ok && t < best_t) {
"""
BRUTE_VARIANTS = {
    "division": [(RCP_LINE, "  const float inv_det = 1.0f / det;\n")],
    "frcp": [(RCP_LINE, "  const float inv_det = __frcp_rn(det);\n")],
    "u reject": [(U_LINE, U_LINE + "  if (!(u >= 0.0f && u <= 1.0f)) return false;\n")],
    "K2 votes a row": [(LOOP, VOTE_LOOP)],
    "one tile": [("  int tile = kThreads;\n  while", "  int tile = kThreads;\n  while (false) while")],
    "full wave": [("2LL * ((num_r + tile - 1) / tile) < slots", "(num_r + tile - 1) / tile < slots")],
    "unroll 4": [("      for (int j = k; j < m; j += lanes) {", "#pragma unroll 4\n      for (int j = k; j < m; j += lanes) {")],
    "5 blocks an SM": [("__launch_bounds__(kThreads)\nbrute", "__launch_bounds__(kThreads, 5)\nbrute")],
}
# FP32 adds, subtracts and multiplies of one K1/K2 pair (44 and u + v)
FP_PER_PAIR = 45
REPS = 20
_I = ctypes.c_int


def variant(src: Path, out: Path, edits) -> Path:
  """The source with each (old, new) replaced once, written to `out`."""
  text = src.read_text()
  for old, new in edits:
    if text.count(old) != 1:
      raise RuntimeError(f"kernel_steps: {src.name} no longer holds {old!r} once")
    text = text.replace(old, new)
  out.write_text(text)
  return out


def start_build(label: str, src: Path, out_dir: Path, probe: str | None = None):
  """Starts nvcc for the library of `src` (and a cubin of `probe`, a source
  that includes it); returns (library, cubin or None, [processes])."""
  stem = re.sub(r"[^a-z0-9]+", "_", label)
  lib, cubin = out_dir / f"lib{stem}.so", None
  procs = [subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
  if probe is not None:
    cubin, probe_src = out_dir / f"probe_{stem}.cubin", out_dir / f"probe_{stem}.cu"
    probe_src.write_text(f'#include "{src.resolve()}"\n' + probe)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs.append(subprocess.Popen([_build.nvcc(), *flags, "-cubin", "-o", str(cubin),
                                   str(probe_src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  return lib, cubin, procs


def finish_build(label: str, procs) -> str:
  """Waits for a build's processes; returns the library's nvcc log."""
  logs = [p.communicate()[0] for p in procs]
  for p, log in zip(procs, logs):
    if p.returncode != 0:
      raise RuntimeError(f"nvcc failed for {label}:\n{log}")
  return logs[0]


def ptxas_usage(log: str, kernels: dict) -> dict:
  """{label: ptxas lines} for each kernel of a log; `kernels` maps a
  function to its label ((mangled name part, label) pairs, first match)."""
  usage, current = {}, None
  for line in log.splitlines():
    m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: |$)", line)
    if m:
      current = next((lab for part, lab in kernels if part in m.group(1)), None)
      continue
    if current and ("registers" in line or "stack frame" in line):
      usage.setdefault(current, []).append(line.split(":", 1)[-1].strip())
  return usage


def sass(binary: Path, out: Path | None) -> dict:
  """{function: [(address, instruction)]}, NOPs left out, of a library or
  cubin."""
  text = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass", str(binary)],
                        capture_output=True, text=True, check=True).stdout
  if out is not None:
    out.write_text(text)
  funcs, current = {}, None
  for line in text.splitlines():
    if "Function :" in line:
      current = line.split("Function :", 1)[1].strip()
      funcs[current] = []
      continue
    m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
    if current and m and not re.match(r"(@\S+\s+)?NOP\b", m.group(2)):
      funcs[current].append((int(m.group(1), 16), m.group(2)))
  return funcs


def named(funcs: dict, kernels) -> dict:
  """{label: value} of `funcs` by the (mangled name part, label) pairs."""
  out = {}
  for name, value in funcs.items():
    lab = next((lab for part, lab in kernels if part in name), None)
    if lab is not None:
      out[lab] = value
  return out


def pair_loops(code) -> list:
  """The loops of a function whose body holds a pair's FADD/FMUL: [(body
  instructions, FADD/FMUL, instructions a pair)], by backward branches to
  an address in the function."""
  loops = []
  for at, (addr, ins) in enumerate(code):
    m = re.search(r"\bBRA\s+(?:\S+\s+)?(0x[0-9a-f]+)", ins)
    if not m or int(m.group(1), 16) >= addr:
      continue
    body = [i for a, i in code if int(m.group(1), 16) <= a <= addr]
    fp = sum(1 for i in body if re.match(r"(@\S+\s+)?F(ADD|MUL)\b", i))
    if fp >= FP_PER_PAIR:
      pairs = max(1, round(fp / FP_PER_PAIR))
      loops.append((len(body), fp, len(body) / pairs))
  return sorted(set(loops))


def each(rays) -> list:
  """A set's ray tuples: one (o, d, t_min, t_max), or a list of them."""
  return rays if isinstance(rays, list) and isinstance(rays[0], tuple) else [rays]


def main_path_calls(scene, config, dev):
  """Every trace call of one iteration (1 spp) of a main path, as the trace
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


def check_builds(libs: dict, sets, call, plain, variants):
  """Each build against the plain versions on every set (each computed
  once); fails if a build that is not a variant differs."""
  wants = [[plain(kind, geo, r) for r in each(rays)] for _, kind, geo, rays in sets]
  for label, lib in libs.items():
    differs = []
    for (rays_label, kind, geo, rays), want in zip(sets, wants):
      for r, w in zip(each(rays), want):
        got = call(lib, kind, geo, r)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, w)):
          differs.append(f"{kind} on {rays_label}")
          break
    if label not in variants:
      chip_smoke.check(not differs, f"{label} differs from the plain versions: {differs}")
    print(f"{label}: " + (f"differs from the plain versions in {differs}" if differs
                          else "bit-equal to the plain versions on every ray set"), flush=True)


def time_in_turns(libs: dict, sets, call, kernel_name: str, names: dict):
  """Each build's device time a call on every set (for a list of ray
  tuples, the mean per launch over the list's calls times their number),
  in order and then reversed; prints both."""
  times = {}
  order = list(libs.items())
  for seq in (order, order[::-1]):
    for label, lib in seq:
      for rays_label, kind, geo, rays in sets:
        # one profiled run of the set's calls: the mean per launch times the calls
        calls = [functools.partial(call, lib, kind, geo, r) for r in each(rays)]
        ms = chip_smoke.kernel_ms(lambda: [c() for c in calls], kernel_name, REPS) * len(calls)
        times.setdefault((rays_label, kind), {}).setdefault(label, []).append(ms)
  for (rays_label, kind), by_label in times.items():
    print(f"{names[kind]} on {rays_label} (ms a call, in order / reversed):", flush=True)
    for label, (a, b) in by_label.items():
      print(f"  {label:18s} {a:.4f} / {b:.4f}", flush=True)


# ------------------------------------------------------------------ K5/K6


BVH_KERNELS = (("bvh_fat_kernel_pack", "K6 pack"), ("bvh_fat_kernelILb1E", "K6"),
               ("bvh_fat_kernelILb0E", "K5"))


def bvh_call(lib, kind: str, scratch: bool, bvh, rays):
  """K5 (kind 'closest') or K6 of a bound library on `rays`, as
  `ops/bvh_trace.py:_launch` calls this tree's; returns the outputs."""
  o, d, t_min, t_max = rays
  n, dev = o.shape[0], o.device
  if kind == "closest":
    outs = [torch.empty(n, dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
  else:
    outs = [torch.empty(n, dtype=torch.bool, device=dev)]
  extra = [torch.empty(n + 2, dtype=torch.int32, device=dev)] if scratch else []
  fn = lib.etx_bvh_intersect_fat if kind == "closest" else lib.etx_bvh_occluded_fat
  rc = fn(bvh.fat_table.data_ptr(), bvh.prim_tris.data_ptr(), None,
          o.data_ptr(), o.stride(0), o.stride(1), d.data_ptr(), d.stride(0), d.stride(1),
          t_min.data_ptr(), t_max.data_ptr(), n, *(x.data_ptr() for x in [*outs, *extra]),
          torch.cuda.current_stream(dev).cuda_stream)
  if rc != 0:
    raise RuntimeError(f"kernel_steps: launch failed: {lib.etx_bvh_error_string(rc).decode()}")
  return outs


def bvh_ray_sets(rng, scene, dev, config):
  """[(label, kind, bvh, rays)]: the sets every K5/K6 build is checked and
  timed on."""
  bvh = scene.bvh
  sets = []
  for k in (12, 16, 18, 20):
    rays = chip_smoke.test_rays(rng, *scene[:3], 1 << k, dev, chip_smoke.ROOM)
    sets += [(f"2^{k} test rays", kind, bvh, rays) for kind in ("closest", "anyhit")]
    if k == 18:
      test = rays
  for kind, plain in (("closest", bvh_trace.intersect_fat_plain),
                      ("anyhit", bvh_trace.occluded_fat_plain)):
    zeros = lambda: torch.zeros(test[0].shape[0], dtype=torch.int64, device=dev)
    stats = {"boxes": 0, "tris": 0, "ray_rows": zeros(), "ray_tris": zeros()}
    plain(bvh, *test, stats=stats)
    steps = stats["ray_rows"] + stats["ray_tris"]
    long = steps > steps.double().quantile(0.99)
    sets.append((f"the 2^18 test rays' longest 1% ({int(long.sum())})", kind, bvh,
                 tuple(x[long].contiguous() for x in test)))
  closest, shadow = chip_smoke.capture_bounce(scene, config, dev, chip_smoke.CAPTURE_BOUNCE)
  sets += [("bounce 2", "closest", bvh, closest), ("bounce 2", "anyhit", bvh, shadow)]
  return sets


def bvh_main(args, dev, out_dir: Path) -> None:
  src = _build.SRC_DIR / "bvh_trace.cu"
  srcs = {"this tree": src,
          "sign-select slab": variant(src, out_dir / "bvh_trace_sign.cu",
                                      [(MINMAX_SLAB, SIGN_SLAB)])}
  if args.parent is not None:
    srcs = {"parent": args.parent / "etx_tracer_tpu_torch/csrc/bvh_trace.cu", **srcs}
  builds = {}
  for label, path in srcs.items():
    templated = ("template <bool kPar>\n__device__ __forceinline__ bool box_hit"
                 in path.read_text())
    boxes = ({"row_par": "box_hit<true>", "row_nopar": "box_hit<false>"} if templated
             else {"row_par": "box_hit"})
    probe = "".join(PROBE.format(name=f"etx_probe_{k}", box=b) for k, b in boxes.items())
    builds[label] = (*start_build(label, path, out_dir, probe), list(boxes))
  libs = {}
  for label, (lib_path, cubin, procs, probes) in builds.items():
    log = finish_build(label, procs)
    raw = ctypes.CDLL(str(lib_path))
    # a source whose K5/K6 entries take scratch also reports their occupancy
    scratch = hasattr(raw, "etx_bvh_fat_occupancy")
    libs[label] = (bvh_trace.bind(raw, scratch=scratch), scratch)
    whole = {k: len(v) for k, v in named(sass(lib_path, args.sass / f"{lib_path.stem}.sass"
                                              if args.sass else None), BVH_KERNELS).items()}
    probe = {k: len(v) for k, v in sass(cubin, None).items()}
    note = " | ".join(f"{k}: " + "; ".join(v)
                      for k, v in sorted(ptxas_usage(log, BVH_KERNELS).items()))
    note += f" | SASS instructions {whole}"
    note += " | one row's loads and box tests " + ", ".join(
        f"{name} {probe[f'etx_probe_{name}']}" for name in probes)
    if scratch:
      for any_hit in (False, True):
        blocks, threads = _I(0), _I(0)
        libs[label][0].etx_bvh_fat_occupancy(int(any_hit), ctypes.byref(blocks),
                                             ctypes.byref(threads))
        note += f" | {'K6' if any_hit else 'K5'} {blocks.value} blocks of {threads.value} an SM"
    print(f"build {label}: {note}", flush=True)

  scene, config = chip_smoke.bigscene_scene((512, 512), dev)
  sets = bvh_ray_sets(np.random.default_rng(20261017), scene, dev, config)
  call = lambda lib, kind, bvh, rays: bvh_call(lib[0], kind, lib[1], bvh, rays)
  plain = lambda kind, bvh, rays: (list(bvh_trace.intersect_fat_plain(bvh, *rays))
                                   if kind == "closest"
                                   else [bvh_trace.occluded_fat_plain(bvh, *rays)])
  check_builds(libs, sets, call, plain, ("sign-select slab",))
  calls = main_path_calls(scene, config, dev)
  sets += [("main path, one iteration's calls summed", kind, scene.bvh,
            [rays for k, rays in calls if k == kind]) for kind in ("closest", "anyhit")]
  print_live(sets, bvh_trace.dead_lanes)
  time_in_turns(libs, sets, call, "bvh_fat_kernel", {"closest": "K5", "anyhit": "K6"})


# ------------------------------------------------------------------ K1/K2


BRUTE_KERNELS = (("brute_intersect_kernelILb0E", "K1"), ("brute_intersect_kernelILb1E", "K2"))


def brute_call(lib, kind: str, tris, rays):
  """K1 (kind 'closest') or K2 of a bound library: its outputs, a list."""
  out = brute_trace.launch_with(lib, "intersect" if kind == "closest" else "occluded",
                                *tris, *rays)
  return list(out) if kind == "closest" else [out]


def brute_plain(kind: str, tris, rays):
  if kind == "closest":
    return list(brute_trace.intersect_plain(*tris, *rays))
  return [brute_trace.occluded_plain(*tris, *rays)]


def all_live(rays):
  """The rays with every dead lane's interval opened to [t_min, 1e30]."""
  o, d, t_min, t_max = rays
  return o, d, t_min, torch.where(brute_trace.dead_lanes(t_min, t_max), 1e30, t_max)


def brute_ray_sets(rng, scene, config, dev):
  """[(label, kind, triangles, rays)]: the sets every K1/K2 build is checked
  and timed on (the main path's calls are added after the check)."""
  cornell = list(scene[:3])
  soup = chip_smoke.tri_soup(rng, 128, dev)
  big = list(bigscene.build_bigscene((16, 16)).build(device=dev)[0][:3])
  sets = []
  for label, tris in (("2^18 test rays x 36 (Cornell)", cornell),
                      ("2^18 test rays x 128 (soup)", soup)):
    rays = chip_smoke.test_rays(rng, *tris, chip_smoke.RAYS, dev)
    sets += [(label, kind, tris, rays) for kind in ("closest", "anyhit")]
  closest, shadow = chip_smoke.capture_bounce(scene, config, dev, chip_smoke.CAPTURE_BOUNCE)
  sets += [("Cornell bounce 2", "closest", cornell, closest),
           ("Cornell bounce 2", "anyhit", cornell, shadow)]
  for k in (12, 14, 16):
    rays = all_live(chip_smoke.test_rays(rng, *cornell, 1 << k, dev))
    sets += [(f"2^{k} live test rays x 36", kind, cornell, rays) for kind in ("closest", "anyhit")]
  sets.append(("2^16 test rays x 15,396 (bigscene)", "closest", big,
               chip_smoke.test_rays(rng, *big, 1 << 16, dev, chip_smoke.ROOM)))
  return sets


def brute_main(args, dev, out_dir: Path) -> None:
  src = _build.SRC_DIR / "brute_trace.cu"
  srcs = {"this tree": src}
  for label, edits in BRUTE_VARIANTS.items():
    srcs[label] = variant(src, out_dir / f"brute_trace_{re.sub(r'[^a-z]+', '_', label)}.cu",
                          edits)
  if args.parent is not None:
    srcs = {"parent": args.parent / "etx_tracer_tpu_torch/csrc/brute_trace.cu", **srcs}
  builds = {label: start_build(label, path, out_dir) for label, path in srcs.items()}
  libs = {}
  for label, (lib_path, _, procs) in builds.items():
    log = finish_build(label, procs)
    libs[label] = brute_trace.bind(ctypes.CDLL(str(lib_path)))
    code = named(sass(lib_path, args.sass / f"{lib_path.stem}.sass" if args.sass else None),
                 BRUTE_KERNELS)
    note = " | ".join(f"{k}: " + "; ".join(v)
                      for k, v in sorted(ptxas_usage(log, BRUTE_KERNELS).items()))
    for k, ins in sorted(code.items()):
      loops = ", ".join(f"{n} instructions with {fp} FADD/FMUL ({per:.1f} a pair)"
                        for n, fp, per in pair_loops(ins))
      note += f" | {k} SASS {len(ins)}; pair loops: {loops or 'none found'}"
    if hasattr(libs[label], "etx_brute_launch_shape"):
      for any_hit in (False, True):
        blocks, tile = _I(0), _I(0)
        libs[label].etx_brute_launch_shape(36, chip_smoke.RAYS, int(any_hit),
                                           ctypes.byref(blocks), ctypes.byref(tile))
        note += (f" | {'K2' if any_hit else 'K1'} {blocks.value} blocks of 256 an SM, "
                 f"{tile.value} rays a block at 2^18 rays")
    print(f"build {label}: {note}", flush=True)

  scene, config = chip_smoke.cornell_scene((512, 512), 1023, dev)
  sets = brute_ray_sets(np.random.default_rng(20261017), scene, config, dev)
  variants = tuple(BRUTE_VARIANTS)
  calls = main_path_calls(scene, config, dev)
  cornell = list(scene[:3])
  sets += [("main path, one iteration's calls summed", kind, cornell,
            [rays for k, rays in calls if k == kind]) for kind in ("closest", "anyhit")]
  check_builds(libs, sets, brute_call, brute_plain, variants)
  print_live(sets, brute_trace.dead_lanes)
  time_in_turns(libs, sets, brute_call, "brute_intersect_kernel", {"closest": "K1", "anyhit": "K2"})


def print_live(sets, dead_lanes):
  """Each set's lanes and the share of them the kernels do not skip."""
  for rays_label, kind, _, rays in sets:
    many = each(rays)
    live = [float((~dead_lanes(r[2], r[3])).float().mean()) for r in many]
    print(f"rays {rays_label} {kind}: " + ", ".join(
        f"{r[0].shape[0]} lanes live {s:.4f}" for r, s in zip(many, live)), flush=True)


def main() -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("family", choices=("bvh", "brute"), help="K5/K6 or K1/K2")
  ap.add_argument("--parent", type=Path, help="an earlier checkout (a git archive)")
  ap.add_argument("--sass", type=Path, help="directory for each library's SASS")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("kernel_steps: no CUDA device; this script runs only on a GPU", file=sys.stderr)
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
  (bvh_main if args.family == "bvh" else brute_main)(args, dev, out_dir)
  print(f"kernel_steps {args.family}: {time.perf_counter() - t0:.1f} s", flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
