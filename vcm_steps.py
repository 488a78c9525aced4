"""A VCM-family iteration with and without the class filter of
`render/bsdf/dispatch.restrict`, in one process on one NVIDIA GPU.

    python3 vcm_steps.py

For each of `chip_smoke.py`'s two VCM-family main paths (the caustics scene
by full VCM, spectral, and the cloud by BDPT, both 256x256), iteration 0
warms up; then iterations 1-2 are timed four times in turns: with the
filter, without it, without, with. "Without" dispatches every listed class
(`restrict` still gives the lanes that are not read no class, which costs
one `torch.where` and changes no value that is read), so the difference is
the lobes that no read lane needs, less the filter's host reads. Prints
seconds, host reads and bounces an iteration for each turn, after the
card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke
from etx_tracer_tpu_torch.models import vcm
from etx_tracer_tpu_torch.ops import _build
from etx_tracer_tpu_torch.render import film as film_mod
from etx_tracer_tpu_torch.render.bsdf import dispatch
from etx_tracer_tpu_torch.scene import caustics

TIMED = (1, 2)


def unfiltered(restrict):
  """`restrict` that keeps every listed class."""
  def every_class(sd, lanes, classes):
    return restrict(sd, lanes, classes)[0], tuple(classes)
  return every_class


def turns(label, scene, config, options, dev):
  restrict = dispatch.restrict
  fs = film_mod.allocate(config.film_width, config.film_height, dev)
  fs, _ = vcm.render_iteration_stats(scene, config, options, fs, 0, device=dev)
  try:
    for variant in ("with", "without", "without", "with"):
      dispatch.restrict = restrict if variant == "with" else unfiltered(restrict)
      with chip_smoke.Counting(((vcm, "_light_step"), (vcm, "_camera_step"))) as counted:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in TIMED:
          fs, _ = vcm.render_iteration_stats(scene, config, options, fs, i, device=dev)
        torch.cuda.synchronize()
        seconds = (time.perf_counter() - t0) / len(TIMED)
      chip_smoke.say("vcm_steps", f"{label}, {variant} the class filter: {seconds:.4f} s an "
                     f"iteration (iterations {TIMED[0]}-{TIMED[-1]}), "
                     f"{counted.host_reads / len(TIMED):.0f} host reads and "
                     f"{counted.bounces / len(TIMED):.0f} bounces an iteration")
  finally:
    dispatch.restrict = restrict


def main() -> int:
  if not torch.cuda.is_available():
    print("vcm_steps: no CUDA device; this script runs only on a GPU", file=sys.stderr)
    return 2
  dev = torch.device("cuda")
  os.environ["XDG_CACHE_HOME"] = str(Path(_build.BUILD_DIR) / "cache")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
  chip_smoke.say("device", smi.stdout.strip().splitlines()[0])
  _build.build_all()
  size = chip_smoke.VCM_SIZE
  turns(f"caustics VCM {size[0]}x{size[1]} spectral mpl 16",
        *caustics.build_caustics_scene(size).build(device=dev), vcm.VCMOptions(), dev)
  turns(f"volumetric BDPT {size[0]}x{size[1]} mpl 10", *chip_smoke.volumetric_scene(size, dev),
        vcm.bdpt_options(), dev)
  return 0


if __name__ == "__main__":
  sys.exit(main())
