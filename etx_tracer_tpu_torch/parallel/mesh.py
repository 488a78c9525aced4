"""Sharded rendering over `torch.distributed`: the film's rows across ranks.

Counterpart of `etx_tracer_tpu/parallel/mesh.py`. The film's row axis is cut
into one band a rank; the scene is replicated; a pixel's RNG stream keys off
its global id and iteration, so each band renders exactly the lanes of the
single-device render. Film heights that the world size does not divide are
padded to `world * band_height`: padded rows trace off-film rays that are
cropped away. Camera-path sums stay in the rank's band. VCM's light-tracing
splats are all-reduced over a full-film image, of which each rank keeps its
band, and the merge grid is built from every rank's light vertices,
all-gathered in rank order.

A rank is a process, as PyTorch does multi-GPU work, where the JAX package
drives a list of devices from one process: the port is bound by its host
(eager PyTorch issues thousands of small kernels a bounce), and one Python
thread that drove several cards would serialise their launches. `launch`
spawns the ranks, each with its own device, and joins them with a deadline;
inside a rank, `make_mesh` gives the `Mesh` (process group, rank, world size,
device) that the sharded functions take.

Backends: NCCL on CUDA, one card a rank (NCCL refuses two ranks on one
card); gloo on the CPU. Ranks that share one card use gloo, and only when
the caller names both: gloo moves CUDA tensors through the host, so times
taken that way say nothing of scaling over cards. Nothing picks a backend
for the caller, and ranks with no device named render on the cards, under
either backend: the CPU is asked for by name.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from etx_tracer_tpu_torch import resolve_device
from etx_tracer_tpu_torch.models import path_tracing
from etx_tracer_tpu_torch.ops import trace
from etx_tracer_tpu_torch.render import film as film_mod
from etx_tracer_tpu_torch.scene import types as st

BACKENDS = ("nccl", "gloo")
# seconds a launch may take, spawning and joining its ranks included
DEFAULT_TIMEOUT = 3600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
  """One rank's view of the pixel mesh."""
  group: Any             # the process group of the mesh
  rank: int
  world: int
  device: torch.device   # where this rank renders
  backend: str


def make_mesh(device=None, group=None) -> Mesh:
  """This rank's mesh inside an initialised process group (default: the
  whole world). `device` defaults to card `rank % device_count`, under
  either backend, and raises without a card; the CPU is asked for by
  name."""
  if not dist.is_initialized():
    raise RuntimeError("make_mesh needs an initialised process group (see launch)")
  group = group or dist.group.WORLD
  rank, world = dist.get_rank(group), dist.get_world_size(group)
  backend = str(dist.get_backend(group))
  device = _default_rank_device(rank) if device is None else torch.device(device)
  if device.type == "cuda" and device.index is None:
    device = torch.device("cuda", torch.cuda.current_device())
  if backend == "nccl" and device.type != "cuda":
    raise ValueError(f"NCCL ranks render on a CUDA card, not on {device}")
  return Mesh(group, rank, world, device, backend)


def _default_rank_device(rank: int) -> torch.device:
  """Card `rank % device_count`; raises without a card."""
  resolve_device(None)
  return torch.device("cuda", rank % torch.cuda.device_count())


def band_height(height: int, world: int) -> int:
  """Rows of each rank's band: the film height padded to a multiple of the
  world size, over the world size."""
  return -(-height // world)


# ---------------------------------------------------------------------------
# Collectives. NCCL and gloo both take all_reduce and the list all_gather on
# CUDA tensors (gloo moves them through the host; `chip_smoke.py` probes
# which collectives gloo takes there), and bool tensors go across as uint8.
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  """The sum of x over the ranks, as a new tensor."""
  out = x.clone()
  dist.all_reduce(out, group=mesh.group)
  return out


def _all_gather(x: torch.Tensor, mesh: Mesh) -> list:
  """Every rank's x, in rank order."""
  src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
  parts = [torch.empty_like(src) for _ in range(mesh.world)]
  dist.all_gather(parts, src, group=mesh.group)
  return [p.bool() for p in parts] if x.dtype == torch.bool else parts


def gather_rows(x: torch.Tensor, mesh: Mesh, rows: int):
  """The ranks' bands of x (row axis first) joined in rank order and cropped
  to `rows`, on rank 0; None on the others."""
  parts = _all_gather(x, mesh)
  return torch.cat(parts)[:rows] if mesh.rank == 0 else None


def gather_film(film_state: film_mod.FilmState, mesh: Mesh, height: int):
  """The full film of `height` rows from the ranks' bands, on rank 0 (None
  on the others), for rank 0 to write."""
  layers = [torch.cat(_all_gather(x, mesh)) if x.dim() >= 2 else x for x in film_state]
  return _crop_rows(film_mod.FilmState(*layers), height) if mesh.rank == 0 else None


def _pad_rows(film_state: film_mod.FilmState, h_pad: int) -> film_mod.FilmState:
  """Zero-pad the film's row axis to h_pad rows."""
  def pad(x):
    if x.dim() >= 2:
      return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, h_pad - x.shape[0]))
    return x
  return film_mod.FilmState(*(pad(x) for x in film_state))


def _crop_rows(film_state: film_mod.FilmState, h: int) -> film_mod.FilmState:
  return film_mod.FilmState(*(x[:h] if x.dim() >= 2 else x for x in film_state))


def shard_film(film_state: film_mod.FilmState, mesh: Mesh) -> film_mod.FilmState:
  """This rank's band of a full film (a resumed render's, say), padded
  rows included, on the rank's device."""
  h = film_state.camera.shape[0]
  local_h = band_height(h, mesh.world)
  padded = _pad_rows(film_state, local_h * mesh.world)
  rows = slice(mesh.rank * local_h, (mesh.rank + 1) * local_h)
  return film_mod.FilmState(*(x[rows].to(mesh.device) if x.dim() >= 2 else x.to(mesh.device)
                              for x in padded))


def allocate_band(config, mesh: Mesh) -> film_mod.FilmState:
  """An empty film band of this rank."""
  return film_mod.allocate(config.film_width, band_height(config.film_height, mesh.world),
                           mesh.device)


# ---------------------------------------------------------------------------
# Sharded renderers
# ---------------------------------------------------------------------------


def render_iteration_sharded(scene, config, film_state: film_mod.FilmState, iteration: int,
                             mesh: Mesh) -> film_mod.FilmState:
  """One film iteration, one lane a pixel, over the mesh: each rank renders
  its band (`film_state`, `band_height` rows, from `allocate_band` or
  `shard_film`) and returns it updated. The full film's height drives the
  camera UVs and the pixel ids of the seeds."""
  h = config.film_height
  local_h = band_height(h, mesh.world)
  if film_state.camera.shape[0] != local_h:
    raise ValueError(f"film band of {film_state.camera.shape[0]} rows, the mesh's are {local_h}")
  local_config = dataclasses.replace(config, film_height=local_h)
  return _render_rows(scene, local_config, film_state, iteration, mesh.rank * local_h, h)


def render_samples_sharded(scene, config, first_iteration: int, num_iterations: int,
                           mesh: Mesh, pool_size: int = path_tracing.POOL_SIZE):
  """The pooled renderer over the mesh: each rank runs the cascade pool
  (`render_samples_static`) on its band with the single-device render's
  seeds, with a pool of at most the band's pixel count (and at least 4,096
  lanes). Returns (the rank's band of FilmSums, `band_height` rows of the
  film, padded rows included; the band's rays; the rays of every rank,
  all-reduced). `gather_rows(sums.table, mesh, W*H)` gives rank 0 the full
  table."""
  w, h = config.film_width, config.film_height
  local_h = band_height(h, mesh.world)
  local_config = dataclasses.replace(config, film_height=local_h)
  local_pool = min(pool_size, max(4096, local_h * w))
  sums, rays = path_tracing.render_samples_static(
      scene, local_config, first_iteration, num_iterations, pool_size=local_pool,
      device=mesh.device, row_offset=mesh.rank * local_h, full_height=h)
  return sums, rays, _all_reduce(rays.reshape(1), mesh)[0]


def vcm_render_iteration_sharded(scene, config, options, film_state: film_mod.FilmState,
                                 iteration: int, mesh: Mesh) -> film_mod.FilmState:
  """One VCM iteration over the mesh; `film_state` is the rank's band.

  Rank k traces the light paths whose ids match its camera band (camera
  pixel i connects to light path i); each rank splats into a full-film
  image, which is all-reduced, and keeps its band of it; the merge grid is
  built from every rank's light vertices and wavelengths, all-gathered in
  rank order, so its vertex array is the single-device one with the padded
  (dead) paths at its end. Every rank computes the same radius schedule on
  the full film, whose true pixel count normalises the estimator; padded
  paths start dead."""
  from etx_tracer_tpu_torch.models import vcm as vcm_mod

  w, h = config.film_width, config.film_height
  local_h = band_height(h, mesh.world)
  h_pad = local_h * mesh.world
  if film_state.camera.shape[0] != local_h:
    raise ValueError(f"film band of {film_state.camera.shape[0]} rows, the mesh's are {local_h}")
  local_config = dataclasses.replace(config, film_height=local_h)
  local_npix = local_h * w
  offset = mesh.rank * local_npix
  radius, vc_weight, vm_weight, vm_norm = (float(x) for x in vcm_mod.radius_schedule(
      scene, config, options, iteration))

  verts, splat_img, l_state = vcm_mod.light_pass(
      scene, local_config, options, iteration, local_npix, vc_weight, vm_weight,
      path_offset=offset, n_valid=w * h, splat_shape=(h_pad, h))
  splat_img = _all_reduce(splat_img, mesh)
  band = splat_img[mesh.rank * local_h:(mesh.rank + 1) * local_h]

  grid = None
  if options.enable_merging:
    all_verts = vcm_mod.LightVertices(*(torch.cat(_all_gather(x, mesh)) for x in verts))
    wl_all = torch.cat(_all_gather(l_state.wl, mesh))
    grid = vcm_mod.build_merge_grid(scene, all_verts, wl_all, radius, config.spectral,
                                    cell_cap=options.max_photons_per_cell)
  camera_rgb = vcm_mod.camera_pass(scene, local_config, options, iteration, verts, grid, radius,
                                   vc_weight, vm_weight, vm_norm, pixel_offset=offset,
                                   full_height=h)
  fs = film_mod.commit_light_iteration(
      film_state._replace(light_iteration=film_state.light_iteration + band))
  colors = camera_rgb.reshape(local_h, w, 3)
  zero = torch.zeros_like(colors)
  return film_mod.accumulate_camera(fs, colors, zero, zero)


def _render_rows(scene, config, film_state, iteration: int, row_offset: int, full_height: int):
  """Render the band of rows [row_offset, row_offset + config.film_height)
  of a film of `full_height` rows into `film_state`, one lane a pixel."""
  state = _make_band_payload(scene, config, iteration, row_offset, full_height)
  while bool(state.alive.any().item()):
    for _ in range(path_tracing._UNROLL):
      state = path_tracing.pt_step(scene, config, state, deferred=False)
  return path_tracing._finalize(scene, config, film_state, state)


def _make_band_payload(scene, config, iteration: int, row_offset: int, full_height: int):
  """`make_payload` of a band, with the full film's pixel ids in the seeds."""
  r = config.film_width * config.film_height
  ids = torch.arange(r, dtype=torch.int64, device=scene.tri_v0.device) + iteration * r
  return path_tracing.make_lane_payload(scene, config, ids, (iteration + 1) * r,
                                       row_offset=row_offset, full_height=full_height)


# ---------------------------------------------------------------------------
# Ranks: one spawned process each
# ---------------------------------------------------------------------------


def launch(fn: Callable, world: int, backend: str, devices=None,
           timeout: float = DEFAULT_TIMEOUT, args: tuple = ()) -> list:
  """Run fn(mesh, *args) on `world` ranks and return their results in rank
  order. Each rank is a process started by the `spawn` method (CUDA cannot
  be forked); the ranks meet through a FileStore under a new temporary
  directory, so no port is bound. `devices[rank]` is the rank's device
  (default: card `rank % device_count`, under either backend; without a
  card the launch raises, and CPU ranks are asked for with "cpu"); `fn`
  and `args` are pickled, so `fn` is a
  module-level function of a module that the ranks can import, and tensors
  in `args` should lie on the CPU. A rank that raises, dies or outlives
  `timeout` seconds (spawning included; also the process group's timeout)
  fails the launch with RuntimeError, and every rank still running is
  killed."""
  if backend not in BACKENDS:
    raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
  devices = ([str(_default_rank_device(r)) for r in range(world)] if devices is None
             else [str(d) for d in devices])
  if len(devices) != world:
    raise ValueError(f"{len(devices)} devices for {world} ranks")
  if backend == "nccl" and len(set(devices)) != world:
    raise ValueError(f"NCCL takes one card a rank, not {devices}; ranks that share a card "
                     "use gloo")
  ctx = multiprocessing.get_context("spawn")
  store_dir = tempfile.mkdtemp(prefix="etx-mesh-")
  init = "file://" + os.path.join(store_dir, "store")
  results = ctx.Queue()
  procs = [ctx.Process(target=_rank_main, name=f"etx-rank-{rank}",
                       args=(rank, world, backend, devices[rank], init, timeout, fn, args,
                             results))
           for rank in range(world)]
  deadline = time.monotonic() + timeout
  try:
    for p in procs:
      p.start()
    out = {}
    while len(out) < world:
      left = deadline - time.monotonic()
      if left <= 0:
        missing = [r for r in range(world) if r not in out]
        raise RuntimeError(f"ranks {missing} of {world} did not finish within {timeout} s")
      try:
        rank, ok, value = results.get(timeout=min(left, 0.5))
      except queue.Empty:
        # a rank reports its own exceptions; a nonzero exit code is a crash
        crashed = [(r, p.exitcode) for r, p in enumerate(procs)
                   if r not in out and p.exitcode not in (None, 0)]
        if crashed:
          raise RuntimeError(f"rank {crashed[0][0]} of {world} exited with code "
                             f"{crashed[0][1]} before it returned") from None
        continue
      if not ok:
        raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
      out[rank] = value
    for p in procs:
      p.join(timeout=max(1.0, deadline - time.monotonic()))
    return [out[r] for r in range(world)]
  finally:
    for p in procs:
      if p.is_alive():
        p.kill()
      if p.pid is not None:
        p.join(timeout=30)
    results.close()
    shutil.rmtree(store_dir, ignore_errors=True)


def _rank_main(rank, world, backend, device, init, timeout, fn, args, results):
  """A rank's process: join the group, build the mesh, run fn, report the
  result or the traceback through `results`, leave the group."""
  try:
    if torch.device(device).type == "cuda":
      torch.cuda.set_device(torch.device(device))
    else:
      # the ranks share the host's cores
      torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
      out = (rank, True, fn(make_mesh(device), *args))
    finally:
      dist.destroy_process_group()
  except Exception:  # reported to the launching process, which fails the launch
    out = (rank, False, traceback.format_exc())
  results.put(out)


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def _start_clock(mesh: Mesh) -> float:
  """Line the ranks up and start a rank's clock: one collective first (NCCL
  sets its communicator up at the first), so a rank's seconds hold its
  render and collectives and not the group's set-up."""
  _all_reduce(torch.zeros(1, device=mesh.device), mesh)
  _sync(mesh.device)
  return time.perf_counter()


def _rank_report(mesh: Mesh, seconds: float, before: dict) -> dict:
  after = trace.launch_counts()
  return {"rank": mesh.rank, "device": str(mesh.device), "seconds": seconds,
          "launches": {k: n - before[k] for k, n in after.items() if n > before[k]}}


def render_samples_job(mesh: Mesh, scene, config, first_iteration: int, num_iterations: int,
                       pool_size: int = path_tracing.POOL_SIZE) -> dict:
  """A rank of a sharded pooled render (`launch(render_samples_job, ...)`,
  the CLI's `--devices`): the scene, on the CPU, goes to the rank's device;
  returns the rank's seconds, kernel launches and rays, the rays of every
  rank, and on rank 0 the full FilmSums table as numpy."""
  scene = st.to_device(scene, mesh.device)
  before = trace.launch_counts()
  t0 = _start_clock(mesh)
  sums, rays, total = render_samples_sharded(scene, config, first_iteration, num_iterations,
                                             mesh, pool_size)
  _sync(mesh.device)
  report = _rank_report(mesh, time.perf_counter() - t0, before)
  table = gather_rows(sums.table, mesh, config.film_width * config.film_height)
  return report | {"rays": int(rays.item()), "rays_total": int(total.item()),
                   "table": None if table is None else table.cpu().numpy()}


def iterations_job(mesh: Mesh, scene, config, first_iteration: int, num_iterations: int,
                   options=None, film=None) -> dict:
  """A rank of a sharded render by iterations: `render_iteration_sharded`
  (path tracing, one lane a pixel) or, with VCM `options`,
  `vcm_render_iteration_sharded`, from an empty band or from the rank's
  band of `film` (a full FilmState on the CPU, such as a checkpoint's, to
  resume). Returns the rank's seconds and kernel launches, and on rank 0
  the full film's layers as numpy ({field: array})."""
  scene = st.to_device(scene, mesh.device)
  fs = allocate_band(config, mesh) if film is None else shard_film(film, mesh)
  before = trace.launch_counts()
  t0 = _start_clock(mesh)
  for it in range(first_iteration, first_iteration + num_iterations):
    if options is None:
      fs = render_iteration_sharded(scene, config, fs, it, mesh)
    else:
      fs = vcm_render_iteration_sharded(scene, config, options, fs, it, mesh)
  _sync(mesh.device)
  report = _rank_report(mesh, time.perf_counter() - t0, before)
  full = gather_film(fs, mesh, config.film_height)
  return report | {"film": None if full is None else {k: v.cpu().numpy()
                                                      for k, v in full._asdict().items()}}


def _dryrun_rank(mesh: Mesh) -> tuple:
  """The dry run's rank: a diffuse Cornell box of 2 * world + 3 rows (no
  world size divides it) through both sharded PT renderers."""
  import numpy as np

  from etx_tracer_tpu_torch.scene import cornell

  h = 2 * mesh.world + 3
  scene, config = cornell.build_cornell_box(film_size=(16, h), diffuse_only=True,
                                            max_path_length=4).build(device=mesh.device)
  fs = render_iteration_sharded(scene, config, allocate_band(config, mesh), 0, mesh)
  cam = gather_film(fs, mesh, h)
  sums, _, rays = render_samples_sharded(scene, config, 0, 2, mesh)
  table = gather_rows(sums.table, mesh, 16 * h)
  if mesh.rank != 0:
    return None
  final = path_tracing.finalize_film(path_tracing.FilmSums(table), 2, 16).camera
  for name, img in (("render_iteration_sharded", cam.camera), ("render_samples_sharded", final)):
    if tuple(img.shape) != (h, 16, 3) or not bool(torch.isfinite(img).all()):
      raise RuntimeError(f"dry run: {name} gave {tuple(img.shape)}, finite "
                         f"{bool(torch.isfinite(img).all())}")
  if int(rays.item()) <= 0:
    raise RuntimeError(f"dry run: {int(rays.item())} rays")
  return np.asarray(final.cpu()).shape, int(rays.item())


def dryrun(n: int, timeout: float = 300.0) -> tuple:
  """Counterpart of the JAX package's `dryrun_multichip`: `n` gloo ranks on
  the CPU render one sharded iteration and two pooled samples of a 16 x
  (2n + 3) Cornell box. Returns (the image's shape, the rays of all ranks);
  raises if a rank fails."""
  return launch(_dryrun_rank, n, "gloo", ["cpu"] * n, timeout)[0]
