"""Trace micro-benchmarks of the port: the kernels head to head, on the card.

    python -m etx_tracer_tpu_torch.benchmarks.micro trace|trace_brute|trace_sorted|trace_oracle
        [--device cpu] [--rays N]

The counterpart of the JAX package's `benchmarks/micro.py` for its four
trace groups, at its sizes, on its scenes (built at 256 x 256), with the
same rays (`_rays`: the same numpy `RandomState` streams):

- `trace`: 2^16 primary, bounce and random rays against bigscene (15,396
  triangles): K5 over the fat rows, and K1 brute force over every triangle;
- `trace_brute`: 2^18 random rays against the materials (996 triangles),
  caustics (1,060) and bigscene (15,396, dense) scenes: the pair-tile K3
  against the Woop K9a (closest hit), K4 against K9b (any hit);
- `trace_sorted`: K5 on bounce and random rays sorted by Morton code of the
  origin and direction octant (`ops/trace._ray_sort_keys`), the sort and
  the permutations inside the timed step;
- `trace_oracle`: K5 on bounce and random rays sorted by their true hit:
  the hit triangle, and the Morton code of the hit position.

Each measurement chains 10 trace steps, each step's ray origins moved by
1e-30 * min(|t|, 1) of the previous step's hits (a data dependency that
leaves the values unchanged), runs one chain to warm up, then times 3
chains with CUDA events and prints seconds per step as the JAX file's lines (ms, Mrays/s, Gpairs/s; ms with four decimals). Where
the JAX groups sweep `rb` (16, 8), a tiling parameter of the TPU kernels
with no counterpart here, one line is printed. Every line is a step of the
wrapper a caller would use, table building included (the Woop wrappers
build their table per call, as the JAX wrapper does).

The entry runs on the CUDA card, and raises without one, unless given
`--device cpu`: then it runs the kernels' plain versions, at the size
`--rays` gives (the tests), one step in one timed chain, and the times are
the CPU's. The JAX file's
other groups (`sort`, `mxu`, `dispatch`, `step`) are later slices of the
port and raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from etx_tracer_tpu_torch import resolve_device
from etx_tracer_tpu_torch.ops import brute2_trace, brute_trace, bvh_trace, woop_trace
from etx_tracer_tpu_torch.ops import trace as trace_ops
from etx_tracer_tpu_torch.ops.brute_trace import Hit
from etx_tracer_tpu_torch.scene import bigscene, caustics, materials

FILM = (256, 256)
SCENES = {"materials": materials.build_materials_scene,
          "caustics": caustics.build_caustics_scene,
          "bigscene": bigscene.build_bigscene}
SIZES = {"trace": 1 << 16, "trace_brute": 1 << 18, "trace_sorted": 1 << 16,
         "trace_oracle": 1 << 16}


class Line(NamedTuple):
  """One printed measurement: the group and label, seconds per step, the
  rays and triangles of a step, and what the first step returned (a Hit,
  or the (R,) bool occlusion)."""
  group: str
  label: str
  seconds: float
  rays: int
  tris: int
  result: Any


@functools.lru_cache(maxsize=None)
def scene(name: str, device: str):
  """The named bench scene at 256 x 256 on `device` (built once)."""
  return SCENES[name](FILM).build(device=device)[0]


def _sync(dev):
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)


# (steps per chain, timed chains): the JAX file's on the card; one of each
# on the CPU, where the plain versions take seconds a step
CHAIN = {"cuda": (10, 3), "cpu": (1, 1)}


def _chain_time(step, state0, dev):
  """step: state -> (state, out). One warm chain of steps, then the timed
  chains from `state0` (CUDA events on the card), as `CHAIN` sets them for
  the device. Returns (seconds per step, the warm chain's first `out`)."""
  n_iter, reps = CHAIN[dev.type]
  state, first = state0, None
  for _ in range(n_iter):
    state, out = step(state)
    first = out if first is None else first
  _sync(dev)
  if dev.type == "cuda":
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
  else:
    t0 = time.perf_counter()
  for _ in range(reps):
    state = state0
    for _ in range(n_iter):
      state, _ = step(state)
  if dev.type == "cuda":
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3
  else:
    seconds = time.perf_counter() - t0
  return seconds / (reps * n_iter), first


def _rays(scn, num_r, kind, dev, seed=0):
  """Ray sets, as the JAX file's `_rays`: 'primary' (coherent camera rays),
  'bounce' (origins on a sphere inside the scene, random directions),
  'random' (fully incoherent)."""
  rs = np.random.RandomState(seed)
  c = scn.bsphere_center.cpu().numpy()
  r = float(scn.bsphere_radius)
  if kind == "primary":
    o = np.tile(c + np.array([0, 0, 2.2 * r]), (num_r, 1)).astype(np.float32)
    side = int(np.sqrt(num_r))
    xs = (np.arange(num_r) % side) / side - 0.5
    ys = (np.arange(num_r) // side % side) / side - 0.5
    d = np.stack([xs * 0.8, ys * 0.8, -np.ones(num_r)], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
  elif kind == "bounce":
    u = rs.normal(size=(num_r, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = (c + u * r * 0.7).astype(np.float32)
    d = rs.normal(size=(num_r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
  else:  # random
    o = (c + rs.uniform(-0.9, 0.9, (num_r, 3)) * r).astype(np.float32)
    d = rs.normal(size=(num_r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
  t_min = np.full(num_r, 1e-4, np.float32)
  t_max = np.full(num_r, 1e30, np.float32)
  return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (o, d, t_min, t_max)]


def _dep(x):
  """1e-30 * min(|x|, 1): adds nothing to O(1) coordinates in float32, but
  makes each step read the previous step's output."""
  return 1e-30 * torch.clamp(torch.abs(x.to(torch.float32)), max=1.0)


def _trace_chain(trace_fn, o, d, tmin, tmax):
  """Chain closest-hit traces through the origin jitter."""
  def step(state):
    o_cur, acc = state
    hit = trace_fn(o_cur, d, tmin, tmax)
    t = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    return (o_cur + _dep(t)[:, None], acc + t.sum()), hit

  return step, (o, torch.zeros((), dtype=torch.float32, device=o.device))


def _occ_chain(occ_fn, o, d, tmin, tmax):
  """Chain any-hit traces through the origin jitter."""
  def step(state):
    o_cur, acc = state
    occ = occ_fn(o_cur, d, tmin, tmax)
    occ_f = occ.to(torch.float32)
    return (o_cur + _dep(occ_f)[:, None], acc + occ_f.sum()), occ

  return step, (o, torch.zeros((), dtype=torch.float32, device=o.device))


def _mrays(line: Line) -> str:
  return f"{line.seconds * 1e3:8.4f} ms  {line.rays / line.seconds / 1e6:8.2f} Mrays/s"


def _fat(scn):
  return functools.partial(bvh_trace.intersect_fat, scn.bvh)


def _dense(fn, scn):
  return functools.partial(fn, scn.tri_v0, scn.tri_e1, scn.tri_e2)


def bench_trace(dev, num_r=None):
  """K5 (fat rows) and K1 (brute force) on bigscene, three ray kinds."""
  scn = scene("bigscene", str(dev))
  num_r = num_r or SIZES["trace"]
  num_t = scn.tri_v0.shape[0]
  print(f"bigscene tris={num_t} nodes={scn.bvh.node_table.shape[0]} "
        f"fat={None if scn.bvh.fat_table is None else tuple(scn.bvh.fat_table.shape)}",
        flush=True)
  lines = []
  for kind in ("primary", "bounce", "random"):
    rays = _rays(scn, num_r, kind, dev)
    for label, fn in (("fat ", _fat(scn)), ("brute", _dense(brute_trace.intersect, scn))):
      dt, hit = _chain_time(*_trace_chain(fn, *rays), dev)
      line = Line("trace", f"{label.strip()} {kind}", dt, num_r, num_t, hit)
      print(f"{label} {kind:8s}      : {_mrays(line)}", flush=True)
      lines.append(line)
  return lines


def bench_trace_brute(dev, num_r=None):
  """The dense kernels head to head: K3 (pair tile) against K9a (Woop) for
  the closest hit, K4 against K9b for the any hit, on random rays."""
  num_r = num_r or SIZES["trace_brute"]
  lines = []
  for name in ("materials", "caustics", "bigscene"):
    scn = scene(name, str(dev))
    num_t = scn.tri_v0.shape[0]
    rays = _rays(scn, num_r, "random", dev)
    print(f"{name}: tris={num_t} rays={num_r} (random)", flush=True)
    for label, mod in (("brute2", brute2_trace), ("woop", woop_trace)):
      dt, hit = _chain_time(*_trace_chain(_dense(mod.intersect, scn), *rays), dev)
      line = Line("trace_brute", f"{name} {label} closest", dt, num_r, num_t, hit)
      print(f"  {label:7s} closest: {_mrays(line)}  {num_r * num_t / dt / 1e9:7.1f} Gpairs/s",
            flush=True)
      lines.append(line)
    for label, mod in (("brute2", brute2_trace), ("woop", woop_trace)):
      dt, occ = _chain_time(*_occ_chain(_dense(mod.occluded, scn), *rays), dev)
      line = Line("trace_brute", f"{name} {label} anyhit", dt, num_r, num_t, occ)
      print(f"  {label:7s} anyhit : {_mrays(line)}", flush=True)
      lines.append(line)
  return lines


def _unpermute(hit: Hit, inv) -> Hit:
  return Hit(hit.t[inv], hit.tri[inv], hit.u[inv], hit.v[inv])


def bench_trace_sorted(dev, num_r=None):
  """K5 on rays sorted by origin Morton code and direction octant, the sort
  and both permutations inside the timed step."""
  scn = scene("bigscene", str(dev))
  num_r = num_r or SIZES["trace_sorted"]
  lines = []
  for kind in ("bounce", "random"):
    rays = _rays(scn, num_r, kind, dev)

    def trace_sorted(o_cur, d, tmin, tmax):
      sorted_rays, inv = trace_ops._sorted_for_trace(scn.bvh, o_cur, d, tmin, tmax)
      return _unpermute(bvh_trace.intersect_fat(scn.bvh, *sorted_rays), inv)

    dt, hit = _chain_time(*_trace_chain(trace_sorted, *rays), dev)
    line = Line("trace_sorted", f"fat+sort {kind}", dt, num_r, scn.tri_v0.shape[0], hit)
    print(f"fat+sort {kind:8s}: {_mrays(line)}", flush=True)
    lines.append(line)
  return lines


def oracle_keys(bvh, o, d, hit):
  """The oracle sort keys of the JAX file: ("tri", the hit triangle, misses
  last) and ("pos", the 27-bit Morton code of the hit position in the root
  box), as int64."""
  key_tri = torch.where(hit.tri >= 0, hit.tri, 1 << 30).to(torch.int64)
  hp = o + d * torch.where(torch.isfinite(hit.t), hit.t, 0.0)[:, None]
  return (("tri", key_tri), ("pos", trace_ops._morton(bvh, hp)))


def bench_trace_oracle(dev, num_r=None):
  """K5 on rays sorted by their true hit: the bound a hit-coherent ray
  order could reach."""
  scn = scene("bigscene", str(dev))
  num_r = num_r or SIZES["trace_oracle"]
  lines = []
  for kind in ("bounce", "random"):
    o, d, tmin, tmax = _rays(scn, num_r, kind, dev)
    hit = bvh_trace.intersect_fat(scn.bvh, o, d, tmin, tmax)
    for name, key in oracle_keys(scn.bvh, o, d, hit):
      perm = torch.argsort(key, stable=True)
      sorted_rays = [x[perm] for x in (o, d, tmin, tmax)]
      dt, first = _chain_time(*_trace_chain(_fat(scn), *sorted_rays), dev)
      line = Line("trace_oracle", f"oracle[{name}] {kind}", dt, num_r, scn.tri_v0.shape[0], first)
      print(f"oracle[{name}] {kind:7s}: {_mrays(line)}", flush=True)
      lines.append(line)
  return lines


GROUPS = {"trace": bench_trace, "trace_brute": bench_trace_brute,
          "trace_sorted": bench_trace_sorted, "trace_oracle": bench_trace_oracle}
LATER = ("sort", "mxu", "dispatch", "step")


def run(group: str, device=None, num_r=None):
  """Run one group on `device` (default: the CUDA card, which must exist);
  prints its lines and returns them."""
  if group in LATER:
    raise NotImplementedError(
        f"micro group {group!r}: the sort, matmul, shading-dispatch and step groups of the "
        "JAX file are a later slice of the port (after the port's bench script)")
  if group not in GROUPS:
    raise ValueError(f"unknown micro group {group!r}; the trace groups are {sorted(GROUPS)}")
  dev = resolve_device(device)
  where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"
  print(f"micro {group} on {where}", flush=True)
  return GROUPS[group](dev, num_r)


def main(argv=None):
  p = argparse.ArgumentParser(prog="python -m etx_tracer_tpu_torch.benchmarks.micro",
                              description=__doc__.splitlines()[0])
  p.add_argument("group", nargs="?", default="trace", help="trace, trace_brute, "
                 "trace_sorted or trace_oracle")
  p.add_argument("--device", default=None, help="cuda (default) or cpu")
  p.add_argument("--rays", type=int, default=None, help="rays per step (default: the JAX "
                 "file's, 2^16 or 2^18)")
  args = p.parse_args(argv)
  return run(args.group, args.device, args.rays)


if __name__ == "__main__":
  main()
  sys.exit(0)
