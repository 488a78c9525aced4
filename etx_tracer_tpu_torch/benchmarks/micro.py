"""Micro-benchmarks of the port: the kernels head to head, sorts, matmuls,
the shading dispatch and the phases of a bounce, on the card.

    python -m etx_tracer_tpu_torch.benchmarks.micro GROUP [--device cpu] [--rays N]

GROUP: trace, trace_brute, trace_sorted, trace_oracle, sort, mxu, dispatch
or step. The counterpart of the JAX package's `benchmarks/micro.py`, group
for group, at its sizes, on its scenes, with the same rays (`_rays`: the
same numpy `RandomState` streams). The trace groups (scenes built at
256 x 256):

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

The other groups, timed the same way (their chains' lengths the JAX file's):

- `sort`: a sort with its permutation (`torch.sort`), an argsort and a
  permutation of (n, 16) rows, a cumulative sum and a scatter-add of
  (n, 16) rows (`index_add_`), at n = 2^14, 2^16 and 2^17;
- `mxu`: the FP32 products (R, 16) x (16, 4T) of the JAX file's binned
  brute-force study by `torch.matmul` with TF32 off, alone and with the
  hit epilogue and the argmin (a timing of the library's matmul: no kernel
  of the port runs);
- `dispatch`: `bsdf.dispatch.sample` over the materials scene's 65,536
  first-hit lanes at 256 x 256, for all its classes at once and for each
  class alone, and `dispatch.evaluate` for all;
- `step`: the phases of one path-tracing bounce on bench config 2 (the
  materials scene at 512 x 512, 262,144 lanes): `pt_step` whole, then the
  closest-hit and any-hit traces, the spectral bank lookup, the hit
  interpolation, NEE's emitter sample, the area emitter's radiance,
  `dispatch.sample`, `dispatch.evaluate` and the film conversion, each
  chained through a data dependency on its input.

The entry runs on the CUDA card, and raises without one, unless given
`--device cpu`: then it runs the kernels' plain versions, at the size
`--rays` gives (the tests; for `sort` and `mxu` the rows, for `dispatch`
and `step` the lanes of a square film), one step in one timed chain, and
the times are the CPU's.
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
from etx_tracer_tpu_torch.core import rng as rng_mod
from etx_tracer_tpu_torch.core import spectrum as sp_mod
from etx_tracer_tpu_torch.models import path_tracing
from etx_tracer_tpu_torch.ops import brute2_trace, brute_trace, bvh_trace, woop_trace
from etx_tracer_tpu_torch.ops import trace as trace_ops
from etx_tracer_tpu_torch.ops.brute_trace import Hit
from etx_tracer_tpu_torch.render import emitters as emitters_mod
from etx_tracer_tpu_torch.render import spectral as spx
from etx_tracer_tpu_torch.render.bsdf import dispatch, lobes
from etx_tracer_tpu_torch.scene import bigscene, caustics, materials, packed

FILM = (256, 256)
SCENES = {"materials": materials.build_materials_scene,
          "caustics": caustics.build_caustics_scene,
          "bigscene": bigscene.build_bigscene}
SIZES = {"trace": 1 << 16, "trace_brute": 1 << 18, "trace_sorted": 1 << 16,
         "trace_oracle": 1 << 16}
SORT_SIZES = (1 << 14, 1 << 16, 1 << 17)
MXU_SHAPES = ((1 << 16, 2048), (1 << 16, 8192), (1 << 14, 2048))
DISPATCH_FILM = (256, 256)
STEP_FILM = (512, 512)


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


def _chain_time(step, state0, dev, n_iter=None):
  """step: state -> (state, out). One warm chain of steps, then the timed
  chains from `state0` (CUDA events on the card), as `CHAIN` sets them for
  the device (`n_iter` steps a chain on the card when given). Returns
  (seconds per step, the warm chain's first `out`)."""
  n_iter_dev, reps = CHAIN[dev.type]
  n_iter = n_iter if n_iter is not None and dev.type == "cuda" else n_iter_dev
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


def _scalar(dev, dtype=torch.float32):
  return torch.zeros((), dtype=dtype, device=dev)


def _ms(line: Line) -> str:
  return f"{line.seconds * 1e3:8.4f} ms"


def bench_sort(dev, num_r=None):
  """Sorts, permutations, a scan and a scatter-add at wavefront widths."""
  rs = np.random.RandomState(0)
  lines = []
  for n in ((num_r,) if num_r else SORT_SIZES):
    keys0 = torch.from_numpy(rs.randint(0, 1 << 30, n).astype(np.int32)).to(dev)
    payload0 = torch.from_numpy(rs.rand(n, 16).astype(np.float32)).to(dev)

    def step_sort(state):
      keys, acc = state
      k2, v = torch.sort(keys, stable=True)
      return (keys ^ (v[0].to(torch.int32) & 1), acc + k2[0]), k2

    def step_perm(state):
      p, acc = state
      q = p[torch.argsort(p[:, 0])]
      return (q, acc + q[0, 0]), q

    def step_cumsum(state):
      k, acc = state
      c = torch.cumsum(k, 0, dtype=torch.int32)
      return (k ^ (c[-1] & 1), acc + c[0]), c

    def step_scatter(state):
      p, acc = state
      idx = (p[:, 0] * n).to(torch.int64) % n
      q = torch.zeros_like(p).index_add_(0, idx, p)
      return (q * 0.5 + p * 0.5, acc + q[0, 0]), q

    for label, fn, st in (("sort_key_val", step_sort, (keys0, _scalar(dev, torch.int32))),
                          ("argsort+permute(n,16)", step_perm, (payload0, _scalar(dev))),
                          ("cumsum", step_cumsum, (keys0, _scalar(dev, torch.int32))),
                          ("scatter-add (n,16)", step_scatter, (payload0, _scalar(dev)))):
      dt, out = _chain_time(fn, st, dev)
      line = Line("sort", f"{label} n={n}", dt, n, 0, out)
      print(f"{label:22s} n={n:7d}: {_ms(line)}", flush=True)
      lines.append(line)
  return lines


def bench_mxu(dev, num_r=None):
  """FP32 matmuls of the binned brute-force tracer's shapes, (R,16) @
  (16,4T), by `torch.matmul` with TF32 off: alone, then with the hit
  epilogue and the argmin over the 4T/4 candidates."""
  rs = np.random.RandomState(0)
  tf32 = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  lines = []
  try:
    for r, t4 in (((num_r, 64),) if num_r else MXU_SHAPES):
      a0 = torch.from_numpy(rs.rand(r, 16).astype(np.float32)).to(dev)
      b0 = torch.from_numpy(rs.rand(16, t4).astype(np.float32)).to(dev)

      def step(state):
        a, acc = state
        out = torch.matmul(a, b0)
        return (a + 0.0 * out[:, :16], acc + out[0, 0]), out

      def step_ep(state):
        a, acc = state
        out = torch.matmul(a, b0)
        det, u, v, tt = out[:, 0::4], out[:, 1::4], out[:, 2::4], out[:, 3::4]
        s = torch.sign(det)
        ok = ((u * s >= 0) & (v * s >= 0) & ((u + v) * s <= det * s)
              & (torch.abs(det) > 1e-9))
        t = torch.where(ok, tt / torch.where(det == 0, 1.0, det), torch.inf)
        best = t.gather(1, torch.argmin(t, dim=-1, keepdim=True))
        return (a + 0.0 * best, acc + torch.where(torch.isfinite(best), best, 0.0).sum()), best

      dt, out = _chain_time(step, (a0, _scalar(dev)), dev)
      line = Line("mxu", f"matmul ({r},16)@(16,{t4})", dt, r, t4 // 4, out)
      print(f"matmul f32 ({r},16)@(16,{t4}): {_ms(line)} "
            f"{2 * r * 16 * t4 / dt / 1e12:6.2f} TFLOP/s", flush=True)
      lines.append(line)
      dt, best = _chain_time(step_ep, (a0, _scalar(dev)), dev)
      line = Line("mxu", f"matmul+epilogue ({r},16)@(16,{t4})", dt, r, t4 // 4, best)
      print(f"  +epilogue+argmin          : {_ms(line)} -> "
            f"{r * (t4 // 4) / dt / 1e9:6.2f} Gpairs/s", flush=True)
      lines.append(line)
  finally:
    torch.backends.cuda.matmul.allow_tf32 = tf32
  return lines


def _film(default, num_r):
  side = int(np.sqrt(num_r)) if num_r else None
  return (side, side) if side else default


def _first_hit(scene, config, dev):
  """The payload of iteration 0, its closest hits and its ShadingData, and
  the scene with its spectral bank at the lanes' wavelengths."""
  state = path_tracing.make_payload(scene, config, 0, device=dev)
  hit = trace_ops.trace_closest(scene, state.ray_o, state.ray_d, state.t_min, state.t_max)
  pos, nrm, tan, btn, uv, _, _, trows = path_tracing._interpolate_hit(scene, hit)
  mat = packed.MaterialRows(scene.mat_table[trows.mat])
  sd = lobes.ShadingData(w_i=state.ray_d, nrm=nrm, tan=tan, btn=btn, geo_n=trows.geo_n,
                         tex=uv, wl=state.wl, medium=state.medium, mat=mat)
  sc = scene
  if config.spectral:
    sc = scene._replace(spec_at_wl=(state.wl, sp_mod.bank_at_wl(scene.spec_values, state.wl)))
  return state, hit, (pos, uv, trows), sd, sc


def bench_dispatch(dev, num_r=None):
  """`dispatch.sample` over a wavefront of first hits on the materials
  scene, all classes and each alone, and `dispatch.evaluate`."""
  scene, config = materials.build_materials_scene(_film(DISPATCH_FILM, num_r)).build(device=dev)
  state, _, _, sd, sc = _first_hit(scene, config, dev)
  r = state.ray_o.shape[0]
  print(f"wavefront r={r} classes={config.material_classes} spectral={config.spectral}",
        flush=True)
  _, rnd0 = rng_mod.next_n(state.rng_state, dispatch.NUM_SAMPLE_RND)

  def chain(fn, label):
    def step(carry):
      rnd, acc = carry
      out = fn(rnd)
      w = out.weight if hasattr(out, "weight") else out[0]
      total = w.sum()
      return (rnd + 0.0 * total, acc + total), out

    dt, out = _chain_time(step, (rnd0, _scalar(dev)), dev, n_iter=5)
    line = Line("dispatch", label, dt, r, 0, out)
    print(f"{label:24s}: {_ms(line)}", flush=True)
    return line

  classes = config.material_classes
  lines = [chain(lambda rnd: dispatch.sample(sc, sd, rnd, config.spectral, classes,
                                             config.diffuse_variations), "sample all-classes")]
  for cls in classes:
    lines.append(chain(lambda rnd, cls=cls: dispatch.sample(sc, sd, rnd, config.spectral, (cls,),
                                                            config.diffuse_variations),
                       f"sample class {int(cls):2d}"))
  lines.append(chain(lambda rnd: dispatch.evaluate(sc, sd, -state.ray_d + 0.0 * rnd[:, :3],
                                                   config.spectral, classes,
                                                   config.diffuse_variations),
                     "evaluate all-classes"))
  return lines


def bench_step(dev, num_r=None):
  """The device time of each phase of a path-tracing bounce on bench
  config 2 (the materials scene, 512 x 512, spectral)."""
  scene, config = materials.build_materials_scene(_film(STEP_FILM, num_r)).build(device=dev)
  state, hit, (pos, uv, trows), sd, sc = _first_hit(scene, config, dev)
  r = state.ray_o.shape[0]
  num_t = scene.tri_v0.shape[0]
  print(f"materials: r={r} tris={num_t} classes={config.material_classes} "
        f"spectral={config.spectral} envs={config.num_env_emitters} media={config.has_media}",
        flush=True)
  lines = []

  def full(s):
    ns = path_tracing.pt_step(scene, config, s, deferred=not config.has_media)
    # keep the width and the liveness of the wavefront
    return ns._replace(alive=s.alive), ns.rays_traced

  dt, _ = _chain_time(full, state, dev, n_iter=16)
  lines.append(Line("step", "pt_step full", dt, r, num_t, None))
  print(f"{'pt_step full':24s}: {_ms(lines[-1])}", flush=True)

  def piece(fn, label, st0=None):
    def step(carry):
      x, acc = carry
      out = fn(x)
      total = (out[0] if isinstance(out, tuple) else out).to(torch.float32).sum()
      return (x + _dep(total), acc + total), out

    x0 = state.ray_o if st0 is None else st0
    dt, out = _chain_time(step, (x0, _scalar(dev)), dev, n_iter=16)
    lines.append(Line("step", label, dt, r, num_t, out))
    print(f"{label:24s}: {_ms(lines[-1])}", flush=True)

  piece(lambda o: trace_ops.trace_closest(scene, o, state.ray_d, state.t_min, state.t_max).t,
        "trace_closest")
  piece(lambda o: trace_ops.trace_occluded(scene, o, state.ray_d, state.t_min,
                                           torch.full((r,), 1e3, device=dev)), "trace_occluded")
  if config.spectral:
    piece(lambda o: sp_mod.bank_at_wl(scene.spec_values, state.wl + 0.0 * o[:, 0]), "bank_at_wl")

  def interp(o):
    h2 = Hit(hit.t, hit.tri, hit.u + 0.0 * o[:, 0], hit.v)
    p2, nrm, tan, _, _, _, _, rows = path_tracing._interpolate_hit(scene, h2)
    mat = packed.MaterialRows(scene.mat_table[rows.mat])
    return p2 + nrm + tan + mat.roughness[:, :1]

  piece(interp, "interpolate+mat")

  def emit(o):
    rs = state.rng_state + (0.0 * o[:, 0]).to(torch.int64)
    _, rnd_sel = rng_mod.next_float(rs)
    _, rnd_em = rng_mod.next_2d(rs)
    em_idx, _ = emitters_mod.sample_emitter_index(sc, rnd_sel)
    return emitters_mod.sample_emitter(sc, em_idx, rnd_em, pos, state.wl, config.spectral,
                                       config.emitter_classes).value

  piece(emit, "sample_emitter(NEE)")
  if config.num_env_emitters > 0:
    piece(lambda o: emitters_mod.env_contribution(
        sc, state.ray_d + 0.0 * o, state.wl, state.path_length == 1, state.mis_flag,
        state.bsdf_pdf, config.num_env_emitters, config.spectral), "env_contribution")
  piece(lambda o: emitters_mod.area_radiance(
      sc, torch.clamp(trows.emitter, min=0), o, pos, state.path_length == 1, state.wl,
      config.spectral)[0], "area_radiance")
  _, rnd0 = rng_mod.next_n(state.rng_state, dispatch.NUM_SAMPLE_RND)
  st7 = torch.tile(state.ray_o, (1, 3))[:, :dispatch.NUM_SAMPLE_RND]
  piece(lambda o: dispatch.sample(sc, sd, rnd0 + 0.0 * o, config.spectral,
                                  config.material_classes, config.diffuse_variations).weight,
        "bsdf.sample", st0=st7)
  piece(lambda o: dispatch.evaluate(sc, sd, -state.ray_d + 0.0 * o[:, :3], config.spectral,
                                    config.material_classes, config.diffuse_variations)[0],
        "bsdf.evaluate", st0=st7)
  piece(lambda o: spx.to_film_rgb(torch.abs(o[:, :1]), state.wl, config.spectral),
        "to_film_rgb")
  return lines


GROUPS = {"trace": bench_trace, "trace_brute": bench_trace_brute,
          "trace_sorted": bench_trace_sorted, "trace_oracle": bench_trace_oracle,
          "sort": bench_sort, "mxu": bench_mxu, "dispatch": bench_dispatch, "step": bench_step}


def run(group: str, device=None, num_r=None):
  """Run one group on `device` (default: the CUDA card, which must exist);
  prints its lines and returns them."""
  if group not in GROUPS:
    raise ValueError(f"unknown micro group {group!r}; the groups are {sorted(GROUPS)}")
  dev = resolve_device(device)
  where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"
  print(f"micro {group} on {where}", flush=True)
  return GROUPS[group](dev, num_r)


def main(argv=None):
  p = argparse.ArgumentParser(prog="python -m etx_tracer_tpu_torch.benchmarks.micro",
                              description=__doc__.splitlines()[0])
  p.add_argument("group", nargs="?", default="trace", help="trace, trace_brute, "
                 "trace_sorted, trace_oracle, sort, mxu, dispatch or step")
  p.add_argument("--device", default=None, help="cuda (default) or cpu")
  p.add_argument("--rays", type=int, default=None, help="rays per step, rows (sort, mxu) or "
                 "lanes (dispatch, step) (default: the JAX file's sizes)")
  args = p.parse_args(argv)
  return run(args.group, args.device, args.rays)


if __name__ == "__main__":
  main()
  sys.exit(0)
