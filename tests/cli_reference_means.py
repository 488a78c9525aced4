"""Image means of the CLI slice's CPU renders, the port's and the JAX
package's: the reference values of `chip_smoke.py`'s CLI gates
(CLI_PT_MEAN, CLI_ADAPTIVE_MEAN and CLI_DEBUG_MEANS are +-10% of the
port's means printed here).

    JAX_PLATFORMS=cpu python -m tests.cli_reference_means [SIZE [WHICH]]

Writes the Cornell scene files (`scene/assets.py`) and renders them at
SIZE x SIZE (default 64) through each package's CLI, as `chip_smoke.py`
does on the card at 640x640: path tracing at the files' 32 spp, the
adaptive render at 64 spp (32 warm, then batches of 8), and the normals
and albedo AOVs. Prints each image's mean and the seconds it took (a few
minutes in all). WHICH ("port", "jax", default both) picks the packages.
"""

import os
import sys
import tempfile
import time

import numpy as np
import torch

RUNS = {
    "pt": [],
    "adaptive": ["--adaptive", "--spp", "64"],
    "debug normals": ["--integrator", "debug", "--aov", "normals"],
    "debug albedo": ["--integrator", "debug", "--aov", "albedo"],
}


def means(cli, image_io, scene_file, size, extra_args):
  out_dir = tempfile.mkdtemp()
  for name, args in RUNS.items():
    out = os.path.join(out_dir, "out.exr")
    t0 = time.perf_counter()
    cli.main(["render", scene_file, "-o", out, "--size", f"{size}x{size}", *args, *extra_args])
    img = image_io.load_exr(out)
    print(f"{name} {size}x{size}: {cli.__name__} mean {float(np.mean(img))!r} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main():
  size = int(sys.argv[1]) if len(sys.argv) > 1 else 64
  which = sys.argv[2] if len(sys.argv) > 2 else "both"
  torch.set_num_threads(4)
  from etx_tracer_tpu_torch.scene import assets
  scene_file = assets.write_cornell_asset(tempfile.mkdtemp())
  os.environ["ETX_TPU_CONFIG_DIR"] = os.path.dirname(scene_file)
  if which in ("port", "both"):
    from etx_tracer_tpu_torch import cli
    from etx_tracer_tpu_torch.utils import image_io
    means(cli, image_io, scene_file, size, ["--device", "cpu"])
  if which in ("jax", "both"):
    import tests.conftest  # noqa: F401  (JAX on the CPU)
    from etx_tracer_tpu import cli as jcli
    from etx_tracer_tpu import native as jnative
    from etx_tracer_tpu_torch import native as pnative
    from etx_tracer_tpu.utils import image_io as jio
    jnative.parse_obj_native = lambda *a, **k: None
    pnative.parse_obj_native = lambda *a, **k: None
    jnative.build_bvh_native = lambda *a, **k: None
    pnative.build_bvh_native = lambda *a, **k: None
    means(jcli, jio, scene_file, size, [])


if __name__ == "__main__":
  main()
