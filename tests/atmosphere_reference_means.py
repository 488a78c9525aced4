"""Image means of bench config 3's CPU renders, the port's and the JAX
package's: the reference value of `chip_smoke.py`'s atmosphere gate
(ATMOSPHERE_MEAN is +-10% of the port's mean luminance at 128x128).

    JAX_PLATFORMS=cpu python -m tests.atmosphere_reference_means [SIDES [WHICH]]

Stages `atmosphere_scene` (the sun and the full 256x128 sky: about 20 s of
numpy in each package) and renders it by path tracing, 8 spp from
iteration 0, at each film side of SIDES (comma-separated, default
"64,128"), the JAX tree built by its numpy builder; prints each image's
mean, its mean luminance (spectral RGB may leave the gamut, luminance may
not) and the seconds it took. WHICH ("port", "jax", default both) sets the
packages.
"""

import sys
import time

import numpy as np
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
from benchmarks import scenes as jscenes
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu_torch import native as pnative
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.render import film as jfilm
from etx_tracer_tpu_torch.core import spectrum
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.scene import atmosphere as patm

SPP = 8


def _line(who, side, img, seconds):
  y = float((img.astype(np.float64) @ spectrum.RGB_TO_XYZ[1]).mean())
  print(f"atmosphere {side}x{side} {SPP} spp: {who} (CPU) mean {float(img.mean())!r}, "
        f"mean luminance {y!r} in {seconds:.1f} s", flush=True)


def main():
  sides = [int(s) for s in (sys.argv[1] if len(sys.argv) > 1 else "64,128").split(",")]
  which = sys.argv[2] if len(sys.argv) > 2 else "both"
  torch.set_num_threads(4)
  jnative.build_bvh_native = lambda *a, **k: None
  pnative.build_bvh_native = lambda *a, **k: None
  for side in sides:
    size = (side, side)
    if which in ("port", "both"):
      t0 = time.perf_counter()
      scene, config = patm.atmosphere_scene(size).build(device="cpu")
      img = pfilm.result_image(ppt.render(scene, config, iterations=SPP, device="cpu")).numpy()
      _line("port", side, img, time.perf_counter() - t0)
    if which in ("jax", "both"):
      t0 = time.perf_counter()
      scene, config = jscenes.atmosphere_scene(size).build()
      img = np.asarray(jfilm.result_image(jpt.render(scene, config, iterations=SPP)))
      _line("JAX", side, img, time.perf_counter() - t0)


if __name__ == "__main__":
  main()
