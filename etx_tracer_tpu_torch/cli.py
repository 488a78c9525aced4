"""Headless command-line renderer on the CUDA card.

Counterpart of `etx_tracer_tpu/cli.py`: load a scene file (JSON, OBJ, glTF),
render it with a chosen integrator, write an EXR or PNG, and optionally
compare it with a reference image.

Usage:
  python -m etx_tracer_tpu_torch.cli render scene.json -o out.exr [--spp N]
      [--integrator pt|bdpt|bdpt-fast|vcm|lt|debug] [--size WxH] [--spectral]
      [--aov normals] [--adaptive] [--devices N] [--reference ref.exr] [--device cpu]
  python -m etx_tracer_tpu_torch.cli render recent     (most recent scene)
  python -m etx_tracer_tpu_torch.cli compare a.exr b.exr
  python -m etx_tracer_tpu_torch.cli cornell -o out.png (built-in scene)
  python -m etx_tracer_tpu_torch.cli view [cornell|scene.json] [--size WxH] [--port P]
      [--device cpu]                                     (web viewer)

`--device` (default: the CUDA card, which must exist) is where the render
runs; `--device cpu` runs the kernels' plain versions on the CPU.
`--devices N` (path tracing) shards the film's rows over N ranks
(`parallel/mesh.py`), one process a card over NCCL, or fewer when fewer
cards are visible (it says so); rank 0 gathers the film. With `--device
cpu` the N ranks run on the CPU over gloo. `view` serves the interactive
viewer (`viewer/server.py`) on localhost.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from etx_tracer_tpu_torch import resolve_device


def _log(msg: str) -> None:
  print(f"[etx-tpu] {msg}", file=sys.stderr)


def _size(text: str):
  w, h = text.lower().split("x")
  return int(w), int(h)


def _load(path, args, device):
  from etx_tracer_tpu_torch.scene import json_scene
  b = json_scene.load_scene(path)
  if args.size:
    b.film_size = _size(args.size)
  if args.spp:
    b.samples = args.spp
  if args.spectral:
    b.spectral = True
  if args.max_path:
    b.max_path_length = args.max_path
  return b.build(device=device)


def _render_image(scene, config, args, device):
  """Render with the selected integrator; returns the (H,W,3) image as
  numpy (row 0 the image bottom)."""
  from etx_tracer_tpu_torch.models import path_tracing
  from etx_tracer_tpu_torch.render import film as film_mod

  spp = args.spp or config.samples
  kind = args.integrator

  if kind == "debug":
    from etx_tracer_tpu_torch.models import debug as debug_mod
    mode = getattr(debug_mod.DebugMode, args.aov.capitalize(), debug_mod.DebugMode.Normals)
    return debug_mod.render_debug(scene, config, mode, device=device).cpu().numpy()

  if kind in ("vcm", "bdpt", "bdpt-fast", "lt"):
    from etx_tracer_tpu_torch.models import vcm
    options = {
        "vcm": vcm.VCMOptions(),
        "bdpt": vcm.bdpt_options(),
        "bdpt-fast": vcm.bdpt_fast_options(),
        "lt": vcm.light_tracing_options(),
    }[kind]
    adaptive = args.adaptive
    if adaptive and kind == "lt":
      # light tracing fills only the light layer; the adaptive stop tests
      # the camera layer's variance, which is zero for lt, and would end the
      # render at the minimum sample count whatever --spp says
      _log("--adaptive is camera-layer based and does not apply "
           "to the lt integrator; rendering all requested samples")
      adaptive = False
    if adaptive:
      fs, _counts = vcm.render_adaptive(scene, config, options=options, max_iterations=spp,
                                        device=device)
    else:
      fs = vcm.render(scene, config, options=options, iterations=spp, device=device)
    return film_mod.result_image(fs).cpu().numpy()

  if args.adaptive:
    fs = path_tracing.render_adaptive(scene, config, max_iterations=spp, device=device)
  else:
    fs, rays = path_tracing.render_stats(scene, config, iterations=spp, device=device)
    _log(f"{int(rays)} rays traced")
  return film_mod.result_image(fs).cpu().numpy()


def _render_sharded(scene, config, args, device):
  """Path tracing sharded over `--devices` ranks (`parallel/mesh.py`): one
  rank a visible card over NCCL (the kernels are built here first, so the
  ranks do not race to build them), or N gloo ranks with `--device cpu`.
  Returns (the camera image as numpy, the ranks' trace kernel launches,
  summed)."""
  from etx_tracer_tpu_torch.models import path_tracing
  from etx_tracer_tpu_torch.ops import _build
  from etx_tracer_tpu_torch.parallel import mesh
  from etx_tracer_tpu_torch.scene import types as st

  spp = args.spp or config.samples
  if device.type == "cuda":
    visible = torch.cuda.device_count()
    n = min(args.devices, visible)
    if n < args.devices:
      _log(f"only {visible} device(s) visible; using {n}")
    backend, devices = "nccl", [f"cuda:{k}" for k in range(n)]
    _build.build_all()
  else:
    n, backend, devices = args.devices, "gloo", [str(device)] * args.devices
  t0 = time.time()
  ranks = mesh.launch(mesh.render_samples_job, n, backend, devices,
                      args=(st.to_device(scene, "cpu"), config, 0, spp))
  launched = {}
  for r in ranks:
    _log(f"rank {r['rank']} on {r['device']}: {r['seconds']:.1f}s, {r['rays']} rays, "
         f"launches {json.dumps(r['launches'])}")
    for k, v in r["launches"].items():
      launched[k] = launched.get(k, 0) + v
  _log(f"{n} {backend} rank(s) in {time.time() - t0:.1f}s (spawn included), "
       f"{ranks[0]['rays_total']} rays traced")
  sums = path_tracing.FilmSums(torch.from_numpy(ranks[0]["table"]))
  return path_tracing.finalize_film(sums, spp, config.film_width).camera.numpy(), launched


def _sync(device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def cmd_render(args):
  from etx_tracer_tpu_torch.utils import image_io, prefs

  device = resolve_device(args.device)
  if args.scene == "recent":
    recent = prefs.recent_files()
    if not recent:
      _log("no recent scene files")
      return
    args.scene = recent[0]
    _log(f"rendering most recent scene: {args.scene}")
  if os.path.exists(args.scene):
    prefs.add_recent(args.scene, integrator=args.integrator)
  scene, config = _load(args.scene, args, device)
  _log(f"scene loaded: {int(scene.tri_v0.shape[0])} triangles, "
       f"{config.film_width}x{config.film_height}, {config.samples} spp, "
       f"classes={config.material_classes}")

  from etx_tracer_tpu_torch.ops import trace

  before = trace.launch_counts()
  t0 = time.time()
  if args.devices and args.devices > 1 and args.integrator == "pt":
    img, launched = _render_sharded(scene, config, args, device)
  else:
    img = _render_image(scene, config, args, device)
    _sync(device)
    launched = {k: n - before[k] for k, n in trace.launch_counts().items() if n > before[k]}
  _log(f"{args.integrator} rendered in {time.time() - t0:.1f}s")
  if device.type == "cuda":
    _log(f"trace kernel launches: {json.dumps(launched)}")

  out = args.output or "out.exr"
  if out.endswith(".png"):
    image_io.save_png(out, img)
  else:
    image_io.save_exr(out, img)
  _log(f"wrote {out}")

  if args.reference:
    ref = image_io.load_exr(args.reference)
    print(json.dumps({"rmse_vs_reference": image_io.rmse(ref, img[::-1])}))


def cmd_cornell(args):
  from etx_tracer_tpu_torch.models import path_tracing
  from etx_tracer_tpu_torch.render import film as film_mod
  from etx_tracer_tpu_torch.scene import cornell
  from etx_tracer_tpu_torch.utils import image_io

  device = resolve_device(args.device)
  size = _size(args.size or "512x512")
  b = cornell.build_cornell_box(film_size=size, samples=args.spp or 32, spectral=args.spectral)
  scene, config = b.build(device=device)
  t0 = time.time()
  fs = path_tracing.render(scene, config, device=device)
  img = film_mod.result_image(fs).cpu().numpy()
  _log(f"cornell {size[0]}x{size[1]} @ {config.samples}spp in {time.time() - t0:.1f}s")
  out = args.output or "cornell.png"
  (image_io.save_png if out.endswith(".png") else image_io.save_exr)(out, img)
  _log(f"wrote {out}")


def cmd_compare(args):
  from etx_tracer_tpu_torch.utils import image_io
  a = image_io.load_exr(args.a)
  b = image_io.load_exr(args.b)
  print(json.dumps({"rmse": image_io.rmse(a, b)}))


def cmd_view(args):
  from etx_tracer_tpu_torch.viewer import server as viewer_server

  device = resolve_device(args.device)
  if args.scene == "cornell":
    from etx_tracer_tpu_torch.scene import cornell
    b = cornell.build_cornell_box(film_size=_size(args.size or "512x512"), max_path_length=8)
  else:
    from etx_tracer_tpu_torch.scene import json_scene
    from etx_tracer_tpu_torch.utils import prefs
    b = json_scene.load_scene(args.scene)
    if args.size:
      b.film_size = _size(args.size)
    prefs.add_recent(args.scene)
  viewer_server.serve(b, port=args.port, device=device)


def main(argv=None):
  p = argparse.ArgumentParser(prog="etx-tpu")
  sub = p.add_subparsers(dest="cmd", required=True)
  device_help = "torch device to render on (default: the CUDA card)"

  pr = sub.add_parser("render")
  pr.add_argument("scene", help="scene file, or 'recent' (most recent from prefs)")
  pr.add_argument("-o", "--output", default=None)
  pr.add_argument("--spp", type=int, default=None)
  pr.add_argument("--size", default=None)
  pr.add_argument("--max-path", type=int, default=None, dest="max_path")
  pr.add_argument("--spectral", action="store_true")
  pr.add_argument("--integrator", default="pt",
                  choices=["pt", "bdpt", "bdpt-fast", "vcm", "lt", "debug"])
  pr.add_argument("--aov", default="normals")
  pr.add_argument("--adaptive", action="store_true",
                  help="adaptive per-pixel sampling (pt/vcm/bdpt; "
                       "ignored for lt, whose camera layer is empty)")
  pr.add_argument("--devices", type=int, default=None,
                  help="shard the film's rows over N ranks (pt only): one a visible card "
                       "over NCCL, or N CPU ranks over gloo with --device cpu")
  pr.add_argument("--reference", default=None)
  pr.add_argument("--device", default=None, help=device_help)
  pr.set_defaults(fn=cmd_render)

  pc = sub.add_parser("cornell")
  pc.add_argument("-o", "--output", default=None)
  pc.add_argument("--spp", type=int, default=None)
  pc.add_argument("--size", default=None)
  pc.add_argument("--spectral", action="store_true")
  pc.add_argument("--device", default=None, help=device_help)
  pc.set_defaults(fn=cmd_cornell)

  pm = sub.add_parser("compare")
  pm.add_argument("a")
  pm.add_argument("b")
  pm.set_defaults(fn=cmd_compare)

  pv = sub.add_parser("view")
  pv.add_argument("scene", nargs="?", default="cornell")
  pv.add_argument("--port", type=int, default=8612)
  pv.add_argument("--size", default=None)
  pv.add_argument("--device", default=None, help=device_help)
  pv.set_defaults(fn=cmd_view)

  args = p.parse_args(argv)
  args.fn(args)


if __name__ == "__main__":
  main()
