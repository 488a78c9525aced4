"""Image means of the VCM slice's CPU renders, the port's and the JAX
package's, at 128x128 and 4 iterations: the reference values of
`chip_smoke.py`'s caustics and volumetric BDPT gates (CAUSTICS_VCM_MEAN,
VOLUMETRIC_BDPT_MEAN are +-10% of the port's).

    JAX_PLATFORMS=cpu python -m tests.vcm_reference_means [SIZE [WHICH]]

Renders bench config 5 (`scene/caustics.build_caustics_scene`, spectral,
full VCM with the default options) and bench config 4
(`scene/volumetric.volumetric`, BDPT) through both packages' `vcm.render`
from iteration 0, the JAX tree built by its numpy builder, and prints each
mean and the seconds it took (a few minutes in all: the JAX package
compiles the caustics VCM for about a minute and a half). The cloud's
`.vol` file goes to $XDG_CACHE_HOME (default ~/.cache). SIZE (default 128)
sets the film's side; WHICH ("port", "jax", default both) the packages.
"""

import sys
import time

import numpy as np
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
from benchmarks import scenes as jscenes
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu_torch import native as pnative
from etx_tracer_tpu.models import vcm as jvcm
from etx_tracer_tpu.render import film as jfilm
from etx_tracer_tpu_torch.models import vcm as pvcm
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.scene import caustics as pcaustics
from etx_tracer_tpu_torch.scene import volumetric as pvol

ITERATIONS = 4


def port_mean(name, builder, factory, size):
  t0 = time.perf_counter()
  scene, config = builder.build(device="cpu")
  fs = pvcm.render(scene, config, getattr(pvcm, factory)(), iterations=ITERATIONS, device="cpu")
  img = pfilm.result_image(fs).numpy()
  print(f"{name} {size[0]}x{size[1]} {ITERATIONS} iterations: port (CPU) mean "
        f"{float(img.mean())!r} in {time.perf_counter() - t0:.1f} s", flush=True)


def jax_mean(name, builder, factory, size):
  t0 = time.perf_counter()
  scene, config = builder.build()
  fs = jvcm.render(scene, config, getattr(jvcm, factory)(), iterations=ITERATIONS)
  img = np.asarray(jfilm.result_image(fs))
  print(f"{name} {size[0]}x{size[1]} {ITERATIONS} iterations: JAX (CPU) mean "
        f"{float(img.mean())!r} in {time.perf_counter() - t0:.1f} s", flush=True)


def main():
  side = int(sys.argv[1]) if len(sys.argv) > 1 else 128
  which = sys.argv[2] if len(sys.argv) > 2 else "both"
  size = (side, side)
  torch.set_num_threads(4)
  jnative.build_bvh_native = lambda *a, **k: None
  pnative.build_bvh_native = lambda *a, **k: None
  cases = (("caustics vcm", jscenes.caustics(size), pcaustics.build_caustics_scene(size),
            "VCMOptions"),
           ("volumetric bdpt", jscenes.volumetric(size), pvol.volumetric(size), "bdpt_options"))
  for name, jb, pb, factory in cases:
    if which != "jax":
      port_mean(name, pb, factory, size)
    if which != "port":
      jax_mean(name, jb, factory, size)


if __name__ == "__main__":
  main()
