"""Image means of the all-classes showcase's CPU renders, the port's and
the JAX package's: the reference value of `chip_smoke.py`'s showcase gate
(SHOWCASE_MEAN is +-10% of the port's mean luminance).

    JAX_PLATFORMS=cpu python -m tests.shading_reference_means [SIDES [WHICH [BACKEND]]]

Stages `tests/shading_showcase.showcase` (nine icospheres of order 2, 2,916
triangles, spectral, path length 16) and renders it by path tracing with
blue noise, SPP spp from iteration 0, at each film side of SIDES
(comma-separated, default "64"), the JAX tree built by its numpy builder;
prints each image's mean, its mean luminance (spectral RGB may leave the
gamut, luminance may not) and the seconds it took. WHICH ("port", "jax",
default both) sets the packages, BACKEND ("lut", the default, or "walk")
both packages' `lobes.MS_BACKEND` (the walked showcase's gate). The JAX
render compiles for about four minutes on a CPU (LUT).
"""

import dataclasses
import sys
import time

import numpy as np
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu_torch import native as pnative
from etx_tracer_tpu.core import spectrum as jspectrum
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.render import film as jfilm
from etx_tracer_tpu.render.bsdf import lobes as jlobes
from etx_tracer_tpu.scene import builder as jbuilder
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.scene import spectral_data as jsdata
from etx_tracer_tpu.scene import types as jtypes
from etx_tracer_tpu_torch.core import spectrum
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.render.bsdf import lobes as plobes
from etx_tracer_tpu_torch.scene import builder as pbuilder
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.scene import spectral_data as psdata
from etx_tracer_tpu_torch.scene import types as ptypes
from tests import shading_showcase

SPP = 4


def _line(who, side, img, seconds):
  y = float((img.astype(np.float64) @ spectrum.RGB_TO_XYZ[1]).mean())
  print(f"showcase {side}x{side} {SPP} spp blue noise {plobes.MS_BACKEND}: {who} (CPU) mean "
        f"{float(img.mean())!r}, "
        f"mean luminance {y!r} in {seconds:.1f} s", flush=True)


def main():
  sides = [int(s) for s in (sys.argv[1] if len(sys.argv) > 1 else "64").split(",")]
  which = sys.argv[2] if len(sys.argv) > 2 else "both"
  plobes.MS_BACKEND = jlobes.MS_BACKEND = sys.argv[3] if len(sys.argv) > 3 else "lut"
  torch.set_num_threads(4)
  jnative.build_bvh_native = lambda *a, **k: None
  pnative.build_bvh_native = lambda *a, **k: None
  for side in sides:
    size = (side, side)
    if which in ("port", "both"):
      t0 = time.perf_counter()
      scene, config = shading_showcase.showcase(pcornell, pbuilder, ptypes, spectrum, psdata,
                                                film_size=size).build(device="cpu")
      config = dataclasses.replace(config, blue_noise=True)
      img = pfilm.result_image(ppt.render(scene, config, iterations=SPP, device="cpu")).numpy()
      _line("port", side, img, time.perf_counter() - t0)
    if which in ("jax", "both"):
      t0 = time.perf_counter()
      scene, config = shading_showcase.showcase(jcornell, jbuilder, jtypes, jspectrum, jsdata,
                                                film_size=size).build()
      config = dataclasses.replace(config, blue_noise=True)
      img = np.asarray(jfilm.result_image(jpt.render(scene, config, iterations=SPP)))
      _line("JAX", side, img, time.perf_counter() - t0)


if __name__ == "__main__":
  main()
